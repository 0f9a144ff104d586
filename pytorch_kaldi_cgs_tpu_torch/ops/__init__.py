"""Kernels (CUDA sources under ``csrc/``) with their plain twins, and the
fbank/MFCC frontend."""
