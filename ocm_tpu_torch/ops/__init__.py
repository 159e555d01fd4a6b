"""Linear algebra, special functions and the hand-written CUDA kernels."""
