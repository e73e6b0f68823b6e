"""The triplane renderer's hand-written kernels against their least time:
the bounds of every lookup pass (csrc/plane_sample.cu) and every splat
(csrc/plane_splat.cu) of the slice's steps, counted from the passes'
logical shapes (benchmark/counts), over the device time of the kernels of
those names in the slice."""

from benchmark import counts

UNIT = "%"


def read(m):
    seconds, n = m.slice.kernel_s(lambda k: "plane_sample" in k or "plane_splat" in k)
    if not n:
        return None
    passes = [p for it in m.slice.its for p in m.cell.render_passes(it)]
    least = sum(counts.lookup_s(p) + (counts.splat_s(p) if p.backward else 0.0) for p in passes)
    return 100.0 * least / seconds
