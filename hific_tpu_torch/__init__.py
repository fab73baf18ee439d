"""hific_tpu_torch: HiFiC in PyTorch for one NVIDIA H100.

A port of the JAX package `hific_tpu` beside it, which stays the reference
that this package is held against: the codec (`codec.py`, with tiling in
`tiling.py`), its command-line tools and serving daemon
(`cli/compress.py`, `cli/decompress.py`, `cli/serve.py`), both training
stages, compression and GAN (`cli/train.py`), and the multi-GPU layer
(`parallel/`: data-parallel training under DDP, one image partitioned
in row bands over devices). Plain convolutions run in
cuDNN through torch; the TPU package's Pallas kernel, ChannelNorm, is a
pair of hand-written CUDA kernels here, forward and backward
(`csrc/channel_norm.cu`), and so are its device rANS coders, encode and
decode (`csrc/rans_device.cu`). Entry points run on `cuda` unless the
caller passes `device="cpu"`.
"""
