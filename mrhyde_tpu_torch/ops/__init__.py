"""Hand-written Hopper kernels (CUDA C++) for the hot assembly paths."""
