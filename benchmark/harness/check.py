"""The numbers that decide `correct`, for a training loop followed for its
first steps by the plain reference.

Readings, of the program and of the reference alike: {'loss': [per step,
a list over lanes], 'grad': [per lane, {leaf: norm of the first step's
gradient}], 'change': [per lane, {leaf: norm of the change over the
steps}]}. A lane is one independently trained state (one image of a
batched stage 2; the one trainable twin of editing).

- grad: by the worst leaf of the worst lane, |norm(program) -
  norm(reference)| over the larger of the reference's norm of that leaf
  and of the median leaf.
- grad_mid: the median leaf's gap, in the median lane: steadier from seed
  to seed than a worst case.
- change: the same as grad for the change over the steps, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's
  (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone).
- change_median: the median leaf's change gap, in the worst lane.

A cell's `limits` name the numbers it compares."""

from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def _gap(p, r, scale):
    """|p - r| / scale; a reading that is not finite is an infinite gap."""
    gap = abs(p - r) / max(scale, 1e-30)
    return gap if math.isfinite(gap) else math.inf


def _gaps(prog: dict, ref: dict) -> dict:
    """{leaf: gap} over the leaves of `ref`, each against the larger of its
    own norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: _gap(prog.get(k, 0.0), r, max(r, med)) for k, r in ref.items()}


def _keep(out, name, gap, where):
    if gap > out.get(name, (-1.0, ""))[0]:
        out[name] = (gap, where)


def numbers(prog: dict, ref: dict) -> dict:
    """{name: (gap, where)} for grad, grad_mid, change and change_median."""
    lanes = list(zip(prog["grad"], ref["grad"], prog["change"], ref["change"]))
    if len(lanes) != len(ref["grad"]) or not lanes:
        lanes = [({}, rg, {}, rc) for rg, rc in zip(ref["grad"], ref["change"])]
    out, mids = {}, []
    for lane, (pg, rg, pc, rc) in enumerate(lanes):
        gaps = _gaps(pg, rg)
        k = max(gaps, key=gaps.get)
        _keep(out, "grad", gaps[k], f"lane {lane} {k}")
        mids.append(statistics.median(gaps.values()))
        med = statistics.median(rg.values())
        moved = {k: rc[k] for k in rc if rg.get(k, 0.0) >= SMALL_GRAD * med}
        gaps = _gaps(pc, moved)
        k = max(gaps, key=gaps.get)
        _keep(out, "change", gaps[k], f"lane {lane} {k}")
        _keep(out, "change_median", statistics.median(gaps.values()), f"lane {lane}")
    out["grad_mid"] = (statistics.median(mids), "median lane")
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, list[str]]:
    """Whether every number named in `limits` is within its limit, and one
    line for each, beside its limit."""
    ok, lines = True, []
    for name, limit in limits.items():
        value, where = nums[name]
        ok &= value <= limit
        lines.append(f"{name}_gap {value:.6g} limit {limit:g} ({where})")
    return ok, lines
