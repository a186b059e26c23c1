"""The paper's own 'architecture': VOLT compiles GPU kernels, not LMs.
This config names the native benchmark suite (volt_bench) so the launcher
can address it alongside the assigned archs; it has no LM shape cells."""
PAPER_BENCHES = [
    "vecadd", "saxpy", "dotproduct", "transpose", "reduce0", "psum",
    "psort", "sfilter", "sgemm", "blackscholes", "bfs", "pathfinder",
    "kmeans", "nearn", "stencil", "spmv", "cfd_like",
    "vote_cuda", "shuffle_cuda", "bscan_cuda", "atomic_aggregate",
]
