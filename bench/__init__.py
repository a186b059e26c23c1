"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: ``python3 bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. ``BENCHMARK.json``
names the cells; each cell's configuration, traffic mix, limits and metrics
are files of their own under this folder, found by name."""
