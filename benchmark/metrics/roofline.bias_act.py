"""The bias + activation kernels (csrc/bias_act.cu) against their least
time: every forward and backward call of the slice's steps, counted from
the layers' logical shapes (benchmark/counts), over the device time of the
kernels of that name in the slice.

Read only in a cell without StyleGAN3's alias-free nonlinearity (the EG3D
cells). Where the entry counts `filtered_lrelu_calls`, most of the
bias_act calls are the nonlinearity's own, and a kernel that fuses it
(its symbol holds `filtered_lrelu`, not `bias_act`) would take their time
out of this reader's denominator but not their work out of its
numerator; `roofline.filtered_lrelu` reads that cell's bias_act calls
whole, against both kernels."""

from benchmark import counts

UNIT = "%"


def read(m):
    if hasattr(m.cell, "filtered_lrelu_calls"):
        return None
    seconds, n = m.slice.kernel_s(lambda k: "bias_act" in k)
    if not n:
        return None
    calls = [c for it in m.slice.its for c in m.cell.bias_act_calls(it)]
    least = sum(counts.bias_act_fwd_s(c) + (counts.bias_act_bwd_s(c) if c.backward else 0.0)
                for c in calls)
    return 100.0 * least / seconds
