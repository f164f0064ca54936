"""Build, load and launch of the hand-written CUDA kernels (csrc/)."""
