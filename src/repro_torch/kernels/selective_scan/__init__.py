"""selective_scan: the Mamba recurrence as a CUDA kernel (replaces the
Pallas ``selective_scan``)."""
