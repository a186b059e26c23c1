"""repro_torch.core — the VOLT compiler, ported beside ``repro.core``.

``vir``, ``graph``, ``frontends`` and ``passes`` are copies of the
reference's modules; ``backends.torch_backend`` lowers VIR to eager torch.
Importing this package imports nothing heavy: each submodule is imported
where it is used.
"""
