"""Device back-ends of the port."""
from .torch_backend import LowerError, TorchKernel, compile_torch  # noqa: F401
