from . import opencl, cuda  # noqa: F401
from .ast_frontend import CompileError, compile_python_kernel  # noqa: F401
