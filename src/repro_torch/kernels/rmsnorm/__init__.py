"""rmsnorm: RMSNorm rows as a CUDA kernel (replaces the Pallas
``rmsnorm``)."""
