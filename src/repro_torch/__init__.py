"""repro_torch — the VOLT reproduction on PyTorch and CUDA (NVIDIA H100).

It mirrors the layout of the JAX package ``repro`` and imports nothing of
it. Entry points run on the card (``device=None`` means ``"cuda"``) and
raise when there is none; tests pass ``device="cpu"``.
"""
