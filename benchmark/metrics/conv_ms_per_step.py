"""Device ms in convolution kernels in the traced slice, over its steps
(ops/conv.py under the StyleGAN2 and StyleGAN3 synthesis, the
superresolution and the VGG nets): cuDNN's direct, implicit-GEMM, Winograd
and FFT kernels (with the FFT's complex products), data and weight
gradients, and the FIR kernels (csrc/upfirdn2d.cu, whose names hold
`depthwise`) where they resample.

In a cell whose entry counts `filtered_lrelu_calls` (StyleGAN3's
alias-free nonlinearity), the kernels named `upfirdn2d` are that
nonlinearity's and are left out: `fir_ms_per_step` holds them there, so
this reads the modulated convolutions alone whether or not the
nonlinearity is fused. Naming rule: a kernel that fuses the nonlinearity
has `filtered_lrelu` in its symbol and none of the words in CONV."""

UNIT = "ms"
CONV = ("conv", "implicit", "fprop", "dgrad", "wgrad", "winograd", "depthwise", "fft")


def is_conv(name: str) -> bool:
    low = name.lower()
    if "elementwise" in low or "copy" in low:  # dtype conversions
        return False
    complex_product = ("float2" in low or "cf32" in low) and ("gemv" in low or "gemm" in low)
    return any(f in low for f in CONV) or complex_product


def read(m):
    sg3 = hasattr(m.cell, "filtered_lrelu_calls")
    seconds, n = m.slice.kernel_s(lambda k: is_conv(k) and not (sg3 and "upfirdn2d" in k))
    return 1e3 * seconds / m.slice.steps if n else None
