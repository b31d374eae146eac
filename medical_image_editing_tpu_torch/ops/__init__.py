"""Numerics: intensity windowing, vector quantization (plain PyTorch and the
fused CUDA kernel), and the build of the package's CUDA sources."""
