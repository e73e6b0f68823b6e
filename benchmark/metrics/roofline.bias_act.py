"""The bias + activation kernels (csrc/bias_act.cu) against their least
time: every forward and backward call of the slice's steps, counted from
the layers' logical shapes (benchmark/counts), over the device time of the
kernels of that name in the slice."""

from benchmark import counts

UNIT = "%"


def read(m):
    seconds, n = m.slice.kernel_s(lambda k: "bias_act" in k)
    if not n:
        return None
    calls = [c for it in m.slice.its for c in m.cell.bias_act_calls(it)]
    least = sum(counts.bias_act_fwd_s(c) + (counts.bias_act_bwd_s(c) if c.backward else 0.0)
                for c in calls)
    return 100.0 * least / seconds
