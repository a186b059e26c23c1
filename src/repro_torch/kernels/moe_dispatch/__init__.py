"""moe_dispatch: the grouped SwiGLU expert feed-forward as a CUDA kernel
(replaces the Pallas ``grouped_expert_ff``)."""
