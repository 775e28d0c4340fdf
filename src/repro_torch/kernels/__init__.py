"""Kernels: plain oracles (``ref``) and the hand-written CUDA kernels:
segment (B1, B2, B6, B7), strided (B3, B4, B5, B8, B9), MoE row routing
(``moe_compact``, B10) and the raw shift networks (``shift_gather``, B11,
B12; ``shift_scatter``, B13, B14)."""
