"""PyTorch/CUDA port of spi_tpu for NVIDIA Hopper (H100).

The JAX package `spi_tpu` is the reference: every module here mirrors
its counterpart's layout and numbers. Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels under `csrc/`,
built at first use into one shared library (see `ops/_lib.py`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""
