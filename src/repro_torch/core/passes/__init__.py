from .pipeline import PassConfig, compile_pipeline, run_pipeline  # noqa: F401
from .uniformity import UniformityInfo, VortexTTI, run_uniformity  # noqa: F401
