"""Operators: CUDA kernel wrappers with plain PyTorch twins, and the portable tiers."""
