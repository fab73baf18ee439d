"""hific_tpu_torch: the HiFiC codec in PyTorch for one NVIDIA H100.

A port of the JAX package `hific_tpu` beside it, which stays the reference
that this package is held against. Plain convolutions run in cuDNN through
torch; the TPU package's Pallas kernel is a hand-written CUDA kernel here
(`csrc/channel_norm.cu`). Entry points run on `cuda` unless the caller
passes `device="cpu"`.
"""
