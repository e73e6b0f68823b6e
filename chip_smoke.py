#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernel library from spi_tpu_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card at
     the shapes its path gives it, and time kernel, plain version,
     PyTorch library yardstick and the roofline bound;
  3. tiny_test_config synthesis forward and w / noise / weight gradients:
     on the card with the kernels versus on the CPU with the plain
     versions, same weights, same injected random draws;
  4. stage-1 'sg' projection at full ffhq512_128_config width (random
     seeded weights), a few steps, with every kernel's launch count;
  5. one more 'sg' step under torch.profiler: the card's time by kernel
     and by kind of kernel, and its busy share of a step;
  6. stage-1 'mir' projection at full width from a yawed camera (two
     cameras rendered from one set of planes);
  7. stage-2 recon-only tuning at full width from phase 4's w and noise;
  8. the probe tools (spi_tpu_torch/tools), each run once.

Each path (phases 3, 4, 6, 7 and each tool) runs with the launch counts
set to 0 just before it and fails unless each kernel it is meant to
launch was launched. Prints the card's name and power limit, one
`{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`. TF32
is off throughout: the port computes in float32, as the JAX reference
does.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

from spi_tpu_torch.tools.timing import bound_ms, time_ms  # fails outside a checkout

TOL_SPLAT = 1e-4     # relative to max |ref|: f32 atomics add in run-dependent order
TOL_SCATTER = 1e-5   # relative to max |ref|: the probes' f32 atomics add in any order
TOL_ELEMWISE = 1e-5  # absolute + relative: same f32 formulas, other libm approximations
TOL_SYNTH = 1e-3     # relative to max |ref|: card vs CPU, other summation orders end to end

# The kernels each path is meant to launch.
INVERSION_KERNELS = ("plane_splat", "bias_act_fwd", "bias_act_bwd")
TOOL_KERNELS = {"profile_gather": ("row_gather",), "probe_scatter": ("row_scatter_add",),
                "probe_winscatter": ("win_scatter",)}
# The tolerance of each tool's `check`: the gather is exact, the scatters
# add f32 in any order (error relative to max |plain|).
TOOL_TOLERANCES = {"profile_gather": 0.0, "probe_scatter": TOL_SCATTER,
                   "probe_winscatter": TOL_SCATTER}


def log(*a):
    print(*a, flush=True)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def coarse_pass_points(dev, res=128, samples=48):
    """The coarse render pass's sample points: canonical camera, res^2
    rays, `samples` stratified depths -> (1, res^2 * samples, 3)."""
    import torch

    from spi_tpu_torch.models.rendering import sample_rays
    from spi_tpu_torch.models.rendering.renderer import sample_stratified
    from spi_tpu_torch.utils import camera as cam

    c = cam.canonical_camera(device=dev)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3), res)
    gen = torch.Generator(device=dev).manual_seed(0)
    depths = sample_stratified(ro, 2.25, 3.3, samples, generator=gen)
    return (ro[:, :, None] + depths * rd[:, :, None]).reshape(1, -1, 3).contiguous()


def phase_splat(dev):
    import torch

    from spi_tpu_torch.ops import plane_splat as ps

    h = w = 256
    c = 32
    coords = coarse_pass_points(dev)
    p = coords.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(1, 3, p, c, device=dev, generator=gen)
    got = ps.splat_cuda(coords, g, 1.0, h, w)
    want = ps.splat_plain(coords, g, 1.0, h, w)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    max_abs = float((got - want).abs().max())
    log(f"splat (1, 3, {p}, {c}) -> 3 x {h}x{w}x{c}: max abs err {max_abs:.3e}, "
        f"rel {err:.3e} (tol {TOL_SPLAT})")
    check(err <= TOL_SPLAT, "splat kernel disagrees with its plain version")

    ms = time_ms(lambda: ps.splat_cuda(coords, g, 1.0, h, w))
    plain = time_ms(lambda: ps.splat_plain(coords, g, 1.0, h, w), iters=5)
    # Yardstick: PyTorch's grid_sample backward on the same three planes
    # (NCHW input, (3, 1, P, 2) grid) for the input gradient only.
    grids = ps.project_onto_planes(coords * 2.0)[0][:, None]  # (3, 1, P, 2)
    inp = torch.zeros(3, c, h, w, device=dev)
    g_nchw = g[0].permute(0, 2, 1)[:, :, None, :].contiguous()  # (3, C, 1, P)
    lib_ms = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, inp, grids, 0, 0, False, [True, False]))
    nbytes = g.numel() * 4 + coords.numel() * 4 + 3 * h * w * c * 4
    b_ms, b_by = bound_ms(nbytes, 3 * 4 * 2 * c * p)
    log(f"splat: kernel {ms:.4f} ms, plain {plain:.4f} ms, grid_sampler_2d_backward "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
    return {"name": "plane_splat", "route": "cuda", "source": "spi_tpu_torch/csrc/plane_splat.cu",
            "replaces": "spi_tpu/ops/plane_splat.py:113", "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def phase_bias_act(dev):
    import torch

    from spi_tpu_torch.ops.bias_act import (
        activation_funcs,
        bias_act_bwd_cuda,
        bias_act_fwd_cuda,
        bias_act_plain,
    )

    # The 256^2 backbone block's activation, and the decoder's hidden
    # layer over one render pass (128^2 rays x 48 samples, 64 wide).
    shapes = {"block256": ((1, 128, 256, 256), 1), "decoder": ((128 * 128 * 48, 64), 1)}
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {}
    worst = {"bias_act_fwd": 0.0, "bias_act_bwd": 0.0}
    for label, (shape, dim) in shapes.items():
        x = torch.randn(*shape, device=dev, generator=gen) * 3.0
        b = torch.randn(shape[dim], device=dev, generator=gen)
        g = torch.randn(*shape, device=dev, generator=gen)
        for act in sorted(activation_funcs):
            spec = activation_funcs[act]
            cfg = (dim, spec.cuda_id, spec.def_alpha, 1.7, 2.5)
            y = bias_act_fwd_cuda(x, b, *cfg)
            dx = bias_act_bwd_cuda(g, x, b, *cfg)
            xr = x.detach().requires_grad_(True)
            yr = bias_act_plain(xr, b, dim=dim, act=act, gain=1.7, clamp=2.5)
            (dxr,) = torch.autograd.grad(yr, xr, g)
            yr = yr.detach()
            torch.cuda.synchronize()
            # Where act(x + b) * gain lies within 4 ulp of the
            # clamp, the two versions may round to opposite sides of it
            # and so keep or zero that element's gradient: such elements
            # are left out of the backward's comparison and counted.
            # Likewise, for relu and selu only, where x + b is exactly 0:
            # at that kink the kernel takes act'(0) by the TPU kernel's
            # rule (the x >= 0 branch), the plain version spi_tpu's
            # impl='xla' rule (the other branch). lrelu takes the x >= 0
            # branch in both.
            pre = bias_act_plain(x, b, dim=dim, act=act, gain=1.7)  # before the clamp
            near = (pre.abs() - 2.5).abs() <= 1e-6
            if act in ("relu", "selu"):
                near |= bias_act_plain(x, b, dim=dim) == 0
            del pre
            n_near = int(near.sum())
            check(n_near <= 1e-4 * x.numel(), f"{n_near} elements at the clamp or kink for {act}")
            errs = {}
            for name, a, r in (("bias_act_fwd", y, yr),
                               ("bias_act_bwd", dx.masked_fill(near, 0), dxr.masked_fill(near, 0))):
                excess = float(((a - r).abs() - TOL_ELEMWISE * (1 + r.abs())).max())
                errs[name] = float((a - r).abs().max())
                worst[name] = max(worst[name], errs[name])
                check(excess <= 0, f"{name} {act} at {label} disagrees: "
                      f"max abs err {errs[name]:.3e}")
            log(f"bias_act {act:8s} {label:8s} {tuple(shape)}: fwd err {errs['bias_act_fwd']:.2e}, "
                f"bwd err {errs['bias_act_bwd']:.2e} ({n_near} elements at the clamp or kink left out)")
        # Times with the main path's activation (lrelu, gain sqrt 2, clamp 256 * sqrt 2).
        spec = activation_funcs["lrelu"]
        cfg = (dim, spec.cuda_id, spec.def_alpha, spec.def_gain, 256.0 * spec.def_gain)
        n = x.numel()
        fwd_ms = time_ms(lambda: bias_act_fwd_cuda(x, b, *cfg))
        bwd_ms = time_ms(lambda: bias_act_bwd_cuda(g, x, b, *cfg))
        fwd_plain = time_ms(lambda: bias_act_plain(x, b, dim=dim, act="lrelu",
                                                      clamp=256.0 * spec.def_gain))
        xr = x.detach().requires_grad_(True)

        def plain_bwd():
            yr = bias_act_plain(xr, b, dim=dim, act="lrelu", clamp=256.0 * spec.def_gain)
            return torch.autograd.grad(yr, xr, g)

        bwd_plain = time_ms(plain_bwd)
        c = shape[dim]
        fb = bound_ms(2 * n * 4 + c * 4, 4 * n)
        bb = bound_ms(3 * n * 4 + c * 4, 5 * n)
        log(f"bias_act lrelu {label} {tuple(shape)}: fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f},"
            f" bound {fb[0]:.4f}), bwd {bwd_ms:.4f} ms (plain fwd+bwd {bwd_plain:.4f}, "
            f"bound {bb[0]:.4f})")
        rows[label] = {"fwd": (fwd_ms, fwd_plain, fb), "bwd": (bwd_ms, bwd_plain, bb)}
        del x, g
    out = []
    fwd_ms, fwd_plain, (fb_ms, fb_by) = rows["block256"]["fwd"]
    bwd_ms, bwd_plain, (bb_ms, bb_by) = rows["block256"]["bwd"]
    src = "spi_tpu_torch/csrc/bias_act.cu"
    out.append({"name": "bias_act_fwd", "route": "cuda", "source": src,
                "replaces": "spi_tpu/ops/bias_act_pallas.py:80",
                "max_abs_err": worst["bias_act_fwd"], "ms": fwd_ms, "plain_ms": fwd_plain,
                "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None})
    out.append({"name": "bias_act_bwd", "route": "cuda", "source": src,
                "replaces": "spi_tpu/ops/bias_act_pallas.py:96",
                "max_abs_err": worst["bias_act_bwd"], "ms": bwd_ms, "plain_ms": bwd_plain,
                "bound_ms": bb_ms, "bound_by": bb_by, "library_ms": None})
    return out


def phase_win_scatter(dev):
    """Row 4: the windowed splat at the probe's shapes (384 tiles of 2048
    points, C = 32, into 256 x 256 x 32), K1 64x64 and 64x32 windows and
    K2 256x48 strips, in f32 and bf16."""
    import torch

    from spi_tpu_torch.ops.win_scatter import win_scatter_cuda, win_scatter_plain
    from spi_tpu_torch.tools.probe_winscatter import C, H, N_TILES, TILE_P, W, WINDOWS, make_inputs

    worst, row = 0.0, None
    for dtype in (torch.float32, torch.bfloat16):
        for name, win_h, win_w, spread in WINDOWS:
            args = make_inputs(N_TILES, win_h, win_w, spread if win_h != H else H - 2, spread,
                               dtype, device=dev, seed=4)
            geom = (win_h, win_w, H, W)
            got = win_scatter_cuda(*args, *geom)
            want = win_scatter_plain(*args, *geom)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            max_abs = float((got - want).abs().max())
            worst = max(worst, max_abs)
            ms = time_ms(lambda: win_scatter_cuda(*args, *geom))
            plain = time_ms(lambda: win_scatter_plain(*args, *geom), iters=3)
            # Bytes: the cotangents, the two coordinate rows of fyx that
            # are read, the offsets and the table; 12 operations a corner
            # and channel pair (hat weights and products) are far below.
            nbytes = (args[2].numel() * args[2].element_size() + 2 * N_TILES * TILE_P * 4
                      + args[0].numel() * 4 + H * W * C * 4)
            b_ms, b_by = bound_ms(nbytes, 12 * N_TILES * TILE_P * C)
            dt = "f32" if dtype == torch.float32 else "bf16"
            log(f"win_scatter {name} {dt}: max abs err {max_abs:.3e}, rel {err:.3e} "
                f"(tol {TOL_SCATTER}); kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
            check(err <= TOL_SCATTER, f"win_scatter {name} {dt} disagrees with its plain version")
            if row is None:  # the table's row: K1 64x64 in f32
                row = (ms, plain, b_ms, b_by)
            del args, got, want
    ms, plain, b_ms, b_by = row
    return {"name": "win_scatter", "route": "cuda", "source": "spi_tpu_torch/csrc/win_scatter.cu",
            "replaces": "tools/probe_winscatter_r5.py:50", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase_row_gather(dev):
    """Row 5: the row gather at the probe's shape (65,536 rows of 32 f32,
    one row index broadcast over the columns) and at the render pass's
    (786,432 rows gathered from 65,536). Bitwise equal to torch.gather."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import row_gather_cuda, row_gather_plain

    gen = torch.Generator(device=dev).manual_seed(10)
    tab = torch.randn(65536, 32, device=dev, generator=gen)
    rows = {}
    for label, n in (("probe", 65536), ("render pass", 786432)):
        idx = torch.randint(0, 65536, (n, 1), device=dev, generator=gen,
                            dtype=torch.int32).expand(n, 32).contiguous()
        idx64 = idx.long()
        got = row_gather_cuda(tab, idx)
        equal = torch.equal(got, row_gather_plain(tab, idx))
        ms = time_ms(lambda: row_gather_cuda(tab, idx))
        plain = time_ms(lambda: row_gather_plain(tab, idx))
        lib_ms = time_ms(lambda: torch.gather(tab, 0, idx64))
        nbytes = 2 * idx.numel() * 4 + tab.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 0)
        log(f"row_gather {label} ({n}, 32) from (65536, 32): bitwise equal {equal}; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms (int32 -> int64 + torch.gather), torch.gather "
            f"int64 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
        check(equal, f"row_gather {label} differs from torch.gather")
        rows[label] = (ms, plain, lib_ms, b_ms, b_by)
    ms, plain, lib_ms, b_ms, b_by = rows["probe"]
    return {"name": "row_gather", "route": "cuda", "source": "spi_tpu_torch/csrc/row_gather.cu",
            "replaces": "tools/profile_gather.py:111", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_row_scatter_add(dev):
    """Row 6: 786,432 rows of 32 f32 added into (65,536, 32) f32, the
    Pallas probe's shape; and the probe_scatter tool's 128 channels with
    0%, 50% and 90% of the rows out of range (dropped by the kernel)."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import row_scatter_add_cuda, row_scatter_add_plain

    gen = torch.Generator(device=dev).manual_seed(11)
    n, n_out = 786432, 65536
    worst, row = 0.0, None
    for c, dead in ((32, 0.0), (128, 0.0), (128, 0.5), (128, 0.9)):
        upd = torch.randn(n, c, device=dev, generator=gen)
        rows = torch.randint(0, n_out, (n, 1), device=dev, generator=gen, dtype=torch.int32)
        n_dead = int(n * dead)
        rows[torch.randperm(n, device=dev, generator=gen)[:n_dead]] = n_out  # interleaved
        rows64 = rows.reshape(-1).long()
        got = row_scatter_add_cuda(rows, upd, n_out)
        want = row_scatter_add_plain(rows, upd, n_out)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        max_abs = float((got - want).abs().max())
        worst = max(worst, max_abs)
        ms = time_ms(lambda: row_scatter_add_cuda(rows, upd, n_out))
        plain = time_ms(lambda: row_scatter_add_plain(rows, upd, n_out))
        # index_add_ has no drop: the yardstick sends dead rows to a sink row.
        lib_ms = time_ms(lambda: torch.zeros(n_out + 1, c, device=dev).index_add_(0, rows64, upd))
        # Bytes: the row ids, the live rows' updates and the table.
        nbytes = (n - n_dead) * c * 4 + rows.numel() * 4 + n_out * c * 4
        b_ms, b_by = bound_ms(nbytes, (n - n_dead) * c)
        log(f"row_scatter_add ({n}, {c}) -> ({n_out}, {c}), {int(dead * 100)}% of rows out of "
            f"range: max abs err {max_abs:.3e}, rel {err:.3e} (tol {TOL_SCATTER}); kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.1f} MB)")
        check(err <= TOL_SCATTER, f"row_scatter_add at C = {c} with {int(dead * 100)}% of rows "
              "out of range disagrees with its plain version")
        if row is None:  # the table's row: the Pallas probe's shape
            row = (ms, plain, lib_ms, b_ms, b_by)
        del upd, rows, rows64, got, want
    ms, plain, lib_ms, b_ms, b_by = row
    return {"name": "row_scatter_add", "route": "cuda",
            "source": "spi_tpu_torch/csrc/row_scatter_add.cu",
            "replaces": "tools/probe_scatter_r5.py:161", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def phase_tiny_synthesis(dev):
    """Card (kernels) vs CPU (plain versions) on tiny_test_config: the
    outputs and the gradients of w, the noise maps and every weight (the
    weight gradients cross each bias_act kernel's bias path and the splat
    into the planes, as stage-2 tuning does)."""
    import torch

    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils import camera as cam
    from spi_tpu_torch.utils.params import extract_noise, replace_noise

    cfg = tiny_test_config()
    gen = torch.Generator().manual_seed(3)
    m = cfg.neural_rendering_resolution ** 2
    draws = {
        "stratified": torch.rand(1, m, cfg.rendering.depth_resolution, 1, generator=gen),
        "exponential": torch.empty(m, cfg.rendering.depth_resolution_importance + 1)
        .exponential_(generator=gen),
    }
    results = {}
    for device in ("cpu", dev):
        g = TriPlaneGenerator(cfg, device=device, seed=0)
        with torch.no_grad():  # nonzero noise strengths, so noise gets a synthesis gradient
            for name, t in g.named_parameters():
                if name.endswith("noise_strength"):
                    t.fill_(0.1)
        ws = (torch.randn(1, g.num_ws, g.w_dim, generator=torch.Generator().manual_seed(4))
              * 0.5).to(device).requires_grad_(True)
        noise = {k: v.clone().requires_grad_(True) for k, v in extract_noise(g).items()
                 if k.startswith("backbone")}
        r1 = torch.randn(1, 3, 128, 128, generator=torch.Generator().manual_seed(5)).to(device)
        r2 = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(6)).to(device)
        before = dict(_lib.launch_counts)
        with replace_noise(g, noise):
            out = g.synthesis(ws, cam.canonical_camera(device=device),
                              draws={k: v.to(device) for k, v in draws.items()})
        loss = (out["image"] * r1).sum() + (out["image_raw"] * r2).sum()
        loss.backward()
        launched = {k: _lib.launch_counts[k] - before[k] for k in before}
        results[device] = ({k: v.detach().cpu() for k, v in out.items()}, ws.grad.cpu(),
                           {k: v.grad.cpu() for k, v in noise.items()},
                           {k: p.grad.cpu() for k, p in g.named_parameters()
                            if p.grad is not None}, launched)
    (ref_out, ref_gw, ref_gn, ref_gp, cpu_launched) = results["cpu"]
    out, gw, gn, gp, launched = results[dev]
    check(not any(cpu_launched.values()), f"CPU run launched kernels: {cpu_launched}")
    check(all(launched[k] for k in INVERSION_KERNELS), f"card run skipped a kernel: {launched}")
    check(set(gp) == set(ref_gp), "the card and the CPU give gradients to other weights")
    errs = {k: rel_err(out[k], ref_out[k]) for k in ref_out}
    errs["grad_ws"] = rel_err(gw, ref_gw)
    errs["grad_noise"] = max(rel_err(gn[k], ref_gn[k]) for k in ref_gn)
    weight_errs = sorted(((rel_err(gp[k], ref_gp[k]), k) for k in ref_gp), reverse=True)
    errs["grad_weights"] = weight_errs[0][0]
    log(f"tiny synthesis: {len(weight_errs)} weight gradients, the worst "
        + ", ".join(f"{k} {e:.2e}" for e, k in weight_errs[:4]))
    log("tiny synthesis card vs CPU, error relative to max |ref|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {TOL_SYNTH})")
    for k, v in errs.items():
        check(math.isfinite(v) and v <= TOL_SYNTH, f"tiny synthesis {k} disagrees: {v:.3e}")


def drive(label, kernels, fn):
    """Run `fn(on_step)` (a workload of spi_tpu_torch/tools/step_time.py)
    with every launch count at 0 and the peak memory reset just before it;
    each step is stamped. Fails unless each of `kernels` was launched.
    Returns (fn's result, launch counts, launches in the last step, median
    s/step after the second)."""
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.tools.step_time import steady_s, time_steps

    counts = []
    _lib.reset_launch_counts()
    result, first_s, step_s, peak = time_steps(
        fn, lambda: counts.append(dict(_lib.launch_counts)))
    launches = dict(_lib.launch_counts)
    steady = steady_s(step_s)
    per_step = {k: counts[-1][k] - counts[-2][k] for k in launches}
    log(f"{label}: {len(counts)} steps, first step {first_s:.4f} s, then "
        f"{[round(t, 5) for t in step_s]} s; median after the second {steady:.5f} s/step")
    log(f"{label}: peak device memory {peak / 2**30:.3f} GiB")
    log(f"{label}: launches {launches}; per step {per_step}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was never launched on the {label} path")
    return result, launches, per_step, steady


def build_model(dev):
    """step_time's workload: ffhq512_128_config at its published widths,
    random seeded weights; LPIPS-VGG16; a random 512^2 target; the
    canonical camera."""
    import torch

    from spi_tpu_torch.tools import step_time

    t0 = time.perf_counter()
    model = step_time.build_model(dev)
    torch.cuda.synchronize()
    log(f"ffhq512_128: {sum(p.numel() for p in model[0].parameters())} generator parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return model


def check_projection(g, label, w, noise, dists):
    import torch

    log(f"{label}: dists {dists.tolist()}")
    check(tuple(w.shape) == (1, g.num_ws, g.w_dim) and bool(torch.isfinite(w).all()),
          f"{label}: w is not finite or has the wrong shape")
    check(bool(torch.isfinite(dists).all()), f"{label}: a projection loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in noise.values()),
          f"{label}: noise is not finite")


def phase_project(dev, model):
    """Stage-1 'sg' projection at full FFHQ-512 width. Returns (w, noise),
    the launch counts of the run and the median step time (s) of the
    steps after the second."""
    from spi_tpu_torch.tools.step_time import PIVOT_STEPS, projection

    (w, noise, dists), launches, _, steady = drive(
        "sg project", INVERSION_KERNELS, projection(model, "sg", PIVOT_STEPS, dev))
    check_projection(model[0], "sg project", w, noise, dists)
    return (w, noise), launches, steady


# Kernel name fragments -> the kind of work, for phase 5's breakdown. cuDNN's
# FFT convolutions run as fft2d_* kernels around complex (float2) products.
KINDS = (
    ("plane_splat", "splat kernel"), ("bias_act", "bias_act kernels"),
    ("fft", "convolution (FFT)"), ("float2", "convolution (FFT)"),
    ("conv", "convolution"), ("implicit", "convolution"), ("wgrad", "convolution"),
    ("dgrad", "convolution"), ("gemm", "matmul"), ("gemv", "matmul"),
    ("index", "gather/scatter"), ("gather", "gather/scatter"), ("scatter", "gather/scatter"),
    ("sort", "sort"), ("reduce", "reduction"), ("scan", "scan (cumsum/cumprod)"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"), ("memset", "memset/copy"),
    ("memcpy", "memset/copy"), ("copy", "memset/copy"),
)


def phase_profile(dev, model, steady_s):
    """The third of three 'sg' steps under torch.profiler: device time by
    kernel and by kind, and its share of phase 4's unprofiled step time
    (the profiler's own overhead stretches the profiled step's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from spi_tpu_torch.tools.step_time import projection

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        projection(model, "sg", 3, dev, seed=9)(lambda step, dist: prof.step())
    per_kernel = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if (t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.key and not evt.key.startswith("ProfilerStep")):
            per_kernel[evt.key] = (t / 1e3, evt.count)
    check(per_kernel, "the profiler saw no device time")
    total = sum(t for t, _ in per_kernel.values())
    kinds = {}
    for name, (t, _) in per_kernel.items():
        low = name.lower()
        kind = next((k for frag, k in KINDS if frag in low), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t
    log(f"profile: one 'sg' step, device time {total:.3f} ms in {len(per_kernel)} kernels")
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"profile kind {kind:24s} {t:10.3f} ms  {100 * t / total:5.1f}%")
    for name, (t, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
        log(f"profile kernel {t:10.3f} ms {n:6d}x  {name[:110]}")
    log(f"profile: device busy {100 * total / (steady_s * 1e3):.1f}% of a step "
        f"(device time over phase 4's median step time {steady_s * 1e3:.3f} ms)")


def phase_mir(dev, model, num_steps=4):
    """Stage-1 'mir' projection at full width from a yawed camera, so that
    the mirror term's weight is nonzero. Both cameras render from one set
    of planes, so each render pass's splat serves both in one launch."""
    from spi_tpu_torch.tools.step_time import MIR_YAW, projection
    from spi_tpu_torch.utils import camera as cam

    camera = cam.canonical_camera(yaw=MIR_YAW, device=dev)
    weight = float(cam.cal_camera_weight(cam.mirror_camera(camera))[0])
    log(f"mir project: yaw {MIR_YAW}, mirror weight {weight:.5f}")
    check(weight > 0, "the mirror term has no weight at this camera")
    (w, noise, dists), _, per_step, steady = drive(
        "mir project", INVERSION_KERNELS, projection(model, "mir", num_steps, dev))
    check_projection(model[0], "mir project", w, noise, dists)
    check(per_step["plane_splat"] == 2,
          f"mir: {per_step['plane_splat']} splat launches a step, not one per render pass")
    return steady


def phase_tune(dev, model, pivot, num_steps=6):
    """Stage-2 recon-only tuning at full width from phase 4's w and noise;
    the threshold is below any LPIPS value, so random weights do not stop
    it early."""
    import torch

    from spi_tpu_torch.tools.step_time import tuning
    from spi_tpu_torch.utils.params import trainable_parameters

    g = model[0]
    before = {k: p.detach().clone() for k, p in trainable_parameters(g).items()}
    (_, (steps, last_lpips)), _, per_step, steady = drive(
        "stage-2 tune", INVERSION_KERNELS, tuning(model, pivot, num_steps, dev))
    after = trainable_parameters(g)
    finite = all(bool(torch.isfinite(p).all()) for p in after.values())
    moved = sum(not torch.equal(before[k], p) for k, p in after.items())
    log(f"stage-2 tune: {steps} steps, last LPIPS {last_lpips:.6f}; weights finite {finite}, "
        f"{moved} of {len(after)} weight tensors moved")
    check(steps == num_steps and math.isfinite(last_lpips), "stage 2 stopped early or diverged")
    check(finite and moved > 0, "the tuned weights are not finite or did not move")
    return steady, per_step


def phase_tools(dev):
    """Each probe tool's run, once, with the launch counts at 0 before it;
    fails where a tool's own check of its kernel against the plain version
    is above the kernel's tolerance."""
    import importlib

    import torch

    from spi_tpu_torch.ops import _lib

    for tool, kernels in TOOL_KERNELS.items():
        mod = importlib.import_module(f"spi_tpu_torch.tools.{tool}")
        t0 = time.perf_counter()
        _lib.reset_launch_counts()
        log(f"== tool {tool}")
        res = mod.run(dev)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _lib.launch_counts.items() if v}
        mod.report(res)
        log(f"tool {tool}: {time.perf_counter() - t0:.1f} s, launches {launches}")
        for k in kernels:
            check(launches.get(k, 0) > 0, f"kernel {k} was never launched by the {tool} tool")
        tol = TOOL_TOLERANCES[tool]
        for case, err in res["check"].items():
            check(math.isfinite(err) and err <= tol,
                  f"tool {tool}: {case} kernel error {err:.3e} above {tol}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from spi_tpu_torch.ops import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    def phase(n, what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {n}: {what} done in {time.perf_counter() - t0:.1f} s")
        return out

    path = phase(1, "build", lambda: (_lib.build(verbose=True), _lib.lib())[0])
    log(f"phase 1: built {path.name}")
    kernels = phase(2, "kernels vs plain", lambda: [
        phase_splat(dev), *phase_bias_act(dev), phase_win_scatter(dev), phase_row_gather(dev),
        phase_row_scatter_add(dev)])
    phase(3, "tiny synthesis card vs CPU", phase_tiny_synthesis, dev)
    model = build_model(dev)
    pivot, launches, sg_s = phase(4, "sg projection", phase_project, dev, model)
    phase(5, "profile", phase_profile, dev, model, sg_s)
    mir_s = phase(6, "mir projection", phase_mir, dev, model)
    tune_s, _ = phase(7, "stage-2 tuning", phase_tune, dev, model, pivot)
    phase(8, "probe tools", phase_tools, dev)
    log(f"median s/step after the second: sg {sg_s:.5f}, mir {mir_s:.5f}, "
        f"stage-2 tune {tune_s:.5f}")
    for k in kernels:  # launches on the inversion ('sg') path
        k["launches"] = launches[k["name"]]
    check([k["name"] for k in kernels] == list(_lib.KERNELS), "a kernel is missing from phase 2")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
