"""Device primitives: torch tensor functions and the hand-written CUDA
kernels (``grid_kernels``, ``promql_kernels``; built by ``cuda_build``)
the grid aggregation and PromQL paths lower to."""
