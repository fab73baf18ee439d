"""hific_tpu_torch: HiFiC in PyTorch for one NVIDIA H100.

A port of the JAX package `hific_tpu` beside it, which stays the reference
that this package is held against: the codec (`codec.py`) and the
compression training stage (`cli/train.py`). Plain convolutions run in
cuDNN through torch; the TPU package's Pallas kernel, ChannelNorm, is a
pair of hand-written CUDA kernels here, forward and backward
(`csrc/channel_norm.cu`), and so are its device rANS coders, encode and
decode (`csrc/rans_device.cu`). Entry points run on `cuda` unless the
caller passes `device="cpu"`.
"""
