"""repro_torch.core — the VOLT compiler and runtime, ported beside ``repro.core``.

Copies of the reference's modules: ``vir``, ``graph``, ``frontends``,
``passes``, the executors (``interp``: the oracle and the decoded,
wg-batched and grid executors; ``interp_mem``; ``parallel``), the
``faults`` taxonomy, the launch ``governor``, the cycle model (``simx``),
the assembler (``backends.asm``) and the ``runtime`` (``Runtime``,
``LaunchService``, the disk caches). What is the port's own:
``backends.torch_backend`` lowers VIR to eager torch, and
``backends.torchgen`` is the runtime's top rung, the certified torch
program that runs a launch on the card where the reference runs a JAX
program. Importing this package imports nothing heavy: each submodule is
imported where it is used.
"""
