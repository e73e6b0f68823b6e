"""Tensor ops of the port (counterpart of spi_tpu/ops).

The kernels of the inversion path are `bias_act`, `upfirdn2d` (the FIR of
every resampling convolution) and `sample_planes`'s lookup forward and
splat backward; everything else on it is plain PyTorch. The probe
kernels `win_scatter` (ops/win_scatter.py) and `row_gather` /
`row_scatter_add` (ops/gather_scatter.py) serve the probe tools.
`filtered_lrelu` (StyleGAN3) is composed of `bias_act` and `upfirdn2d`.
"""

from spi_tpu_torch.ops.bias_act import activation_funcs, bias_act
from spi_tpu_torch.ops.conv import conv2d, conv2d_resample, conv_transpose2d
from spi_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from spi_tpu_torch.ops.grid_sample import grid_sample
from spi_tpu_torch.ops.plane_splat import sample_planes
from spi_tpu_torch.ops.resize import resize_area, resize_bilinear
from spi_tpu_torch.ops.upfirdn2d import downsample2d, setup_filter, upfirdn2d, upsample2d

__all__ = [
    "activation_funcs",
    "bias_act",
    "conv2d",
    "conv2d_resample",
    "conv_transpose2d",
    "downsample2d",
    "filtered_lrelu",
    "grid_sample",
    "resize_area",
    "resize_bilinear",
    "sample_planes",
    "setup_filter",
    "upfirdn2d",
    "upsample2d",
]
