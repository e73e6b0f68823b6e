"""Tensor ops of the port (counterpart of spi_tpu/ops).

The kernels of the inversion path are `bias_act` and the splat backward
of `sample_planes`; everything else on it is plain PyTorch. The probe
kernels `win_scatter` (ops/win_scatter.py) and `row_gather` /
`row_scatter_add` (ops/gather_scatter.py) serve the probe tools.
"""

from spi_tpu_torch.ops.bias_act import bias_act
from spi_tpu_torch.ops.conv import conv2d, conv2d_resample, conv_transpose2d
from spi_tpu_torch.ops.plane_splat import sample_planes
from spi_tpu_torch.ops.resize import resize_area, resize_bilinear
from spi_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d

__all__ = [
    "bias_act",
    "conv2d",
    "conv2d_resample",
    "conv_transpose2d",
    "resize_area",
    "resize_bilinear",
    "sample_planes",
    "setup_filter",
    "upfirdn2d",
    "upsample2d",
]
