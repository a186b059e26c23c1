"""flash_attention: attention forward with an online softmax as a CUDA
kernel (replaces the Pallas ``flash_attention``)."""
