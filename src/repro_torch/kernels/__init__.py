"""Kernels: plain oracles (``ref``) and the hand-written CUDA segment
kernels."""
