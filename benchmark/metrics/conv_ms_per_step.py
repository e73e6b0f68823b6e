"""Device ms in convolution kernels in the traced slice, over its steps
(ops/conv.py under the StyleGAN2 synthesis, the superresolution and the
VGG nets): cuDNN's direct, implicit-GEMM, Winograd and FFT kernels (with
the FFT's complex products), data and weight gradients, and the FIR
filters' depthwise convolutions."""

UNIT = "ms"
CONV = ("conv", "implicit", "fprop", "dgrad", "wgrad", "winograd", "depthwise", "fft")


def is_conv(name: str) -> bool:
    low = name.lower()
    if "elementwise" in low or "copy" in low:  # dtype conversions
        return False
    complex_product = ("float2" in low or "cf32" in low) and ("gemv" in low or "gemm" in low)
    return any(f in low for f in CONV) or complex_product


def read(m):
    seconds, n = m.slice.kernel_s(is_conv)
    return 1e3 * seconds / m.slice.steps if n else None
