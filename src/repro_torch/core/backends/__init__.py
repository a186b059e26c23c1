"""Device back-ends of the port."""
from .asm import emit_asm, static_counts  # noqa: F401
from .torch_backend import LowerError, TorchKernel, compile_torch  # noqa: F401
