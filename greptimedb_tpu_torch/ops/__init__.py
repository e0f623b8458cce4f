"""Device primitives: torch tensor functions and the hand-written CUDA
kernels (``grid_kernels``) the grid aggregation path lowers to."""
