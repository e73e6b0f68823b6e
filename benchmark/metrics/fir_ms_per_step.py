"""Device ms in the kernels of StyleGAN3's alias-free nonlinearity
(ops/filtered_lrelu.py) that filter, in the traced slice, over its steps:
those whose names hold `upfirdn2d` (csrc/upfirdn2d.cu, the up and down
FIRs) or `filtered_lrelu` (a kernel that fuses the operation), forward
and backward. While the nonlinearity runs as separate kernels this is the
FIRs alone, its bias and activation being bias_act's; once fused, it is
the fused kernels, which then hold the bias and activation too.

Naming rule: every device kernel that fuses the nonlinearity, a bias
gradient's reduction included, has `filtered_lrelu` in its symbol and
none of `conv_ms_per_step`'s words (`conv`, `implicit`, `fprop`,
`dgrad`, `wgrad`, `winograd`, `depthwise`, `fft`).

Read only in a cell whose model has that nonlinearity (its entry counts
`filtered_lrelu_calls`); elsewhere the FIRs are the resampling
convolutions' and `conv_ms_per_step` holds them."""

UNIT = "ms"


def read(m):
    if not hasattr(m.cell, "filtered_lrelu_calls"):
        return None
    seconds, n = m.slice.kernel_s(lambda k: "upfirdn2d" in k or "filtered_lrelu" in k)
    return 1e3 * seconds / m.slice.steps if n else None
