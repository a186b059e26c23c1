"""simt_exec: VIR kernels emitted as CUDA C++ (replaces the Pallas
``pallas_simt_launch``)."""
