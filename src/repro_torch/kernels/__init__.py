"""Hand-written Hopper kernels of the port, one package per op.

Each kernel package has:
  csrc/*.cu — the CUDA C++ source (sm_90a), a plain C interface
  kernel.py — ctypes launch wrappers: checks, allocation, launch counter
  ref.py    — the plain PyTorch version: CPU path and the kernel's oracle
  ops.py    — adapter dispatch (torch | cuda)

Kernels:
  zfp_block      — ZFP-X per-4^d-block compress/decompress
  histogram      — Huffman-X key-frequency histogram
  huffman_encode — Huffman-X per-key codebook gather and pack_stream (scan +
                   word packing; no TPU kernel: the reference leaves it to XLA)
  huffman_decode — Huffman-X chunk-parallel canonical decode
  quantize_map   — MGARD-X per-level quantize / dequantize (Map&Process)
  tridiag        — MGARD-X batched Thomas solve of the 1-D mass matrix
  mgard_lerp     — MGARD-X interpolation-coefficient stencil
"""
