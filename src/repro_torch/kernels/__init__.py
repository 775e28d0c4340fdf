"""Kernels: plain oracles (``ref``) and the hand-written CUDA segment
(B1, B2) and strided (B3, B4, B5) kernels."""
