#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent build/<dir> ...]

Phases (any failure exits non-zero):
  1. build the CUDA kernel library from spi_tpu_torch/csrc, and read its
     atomics from the SASS (no CAS-loop shared atomic anywhere);
  2. hold each kernel against its plain PyTorch version on the card at
     the shapes its path gives it (the splat also at a fine and a
     two-camera pass of a full-width render of phase 4's model), and time
     kernel, plain version and PyTorch library yardstick, both
     back-to-back and device-only (tools/timing.py), beside the roofline
     bound; with --parent, time each such checkout's splat and
     win_scatter kernels in turns with this one on the same inputs;
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


# Run by `turns` in a checkout's own directory: times that tree's kernel
# argv[1] (plane_splat or win_scatter) device-only on the saved inputs
# (argv[2]) with this tree's timing module (argv[3]); a tree whose
# splat_cuda takes no geometry gets none.
TURN_CODE = """
import importlib.util, inspect, json, sys
import torch
kernel, saved, timing_path = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("timing", timing_path)
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
torch.backends.cuda.matmul.allow_tf32 = False
if kernel == "plane_splat":
    from spi_tpu_torch.ops import plane_splat as mod
    takes_geom = "geom" in inspect.signature(mod.splat_cuda).parameters
    def call(coords, g, geom):
        extra = (mod.RayGeom(*geom),) if takes_geom and geom else ()
        return lambda: mod.splat_cuda(coords, g, 1.0, 256, 256, *extra)
else:
    from spi_tpu_torch.ops import win_scatter as mod
    def call(offsets, fyx, gft, geom):
        return lambda: mod.win_scatter_cuda(offsets, fyx, gft, *geom)
ms = {}
for label, args in torch.load(sys.argv[2]).items():
    args = [a.cuda() if torch.is_tensor(a) else a for a in args]
    ms[label] = timing.device_ms(call(*args))
print(json.dumps({"tree": mod.__file__, "ms": ms}))
"""


def turns(parent, kernel, inputs):
    """Device-only times of `kernel`'s wrapper in the parent checkout
    `parent` and in this one on the same card, in turns (parent, this,
    this, parent), each in a process of its own run from its tree.
    `inputs`: {label: the wrapper's tensor and shape arguments}, saved
    to the CPU and reloaded on the card by each turn."""
    import os
    from pathlib import Path

    import torch

    here = Path(__file__).resolve().parent
    saved = here / "build" / f"{kernel}_turns.pt"
    saved.parent.mkdir(exist_ok=True)
    torch.save({k: tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
                for k, args in inputs.items()}, saved)
    timing = here / "spi_tpu_torch" / "tools" / "timing.py"
    runs = []
    for tree in (Path(parent).resolve(), here, here, Path(parent).resolve()):
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, "-c", TURN_CODE, kernel, str(saved), str(timing)],
                              cwd=tree, env=env, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"{kernel} turn in {tree} failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        log(f"{kernel} turn {'parent' if tree != here else 'this tree'} ({runs[-1]['tree']}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in runs[-1]["ms"].items()))
    saved.unlink()
    return runs


def sass_atomics(path):
    """{kernel function: {atomic or reduction opcode: count}} in the SASS of
    the built library (cuobjdump -sass). Fails if any shared-memory atomic
    is a compare-and-swap loop (ATOMS.CAST.SPIN, what an f32 atomicAdd to
    shared memory compiles to) or if a win_scatter kernel adds to global
    memory other than by REDG."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[\w.]+)", line)
        if m and func:
            ops = counts.setdefault(func, {})
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    for func, ops in counts.items():
        log(f"sass {func}: {ops}")
        check(not any("CAST.SPIN" in op for op in ops), f"{func} has a CAS-loop shared atomic")
        if "win_scatter" in func:
            check(all(op.startswith(("REDG", "ATOMS.ADD")) for op in ops),
                  f"{func} adds other than by REDG and integer ATOMS.ADD: {ops}")
    return counts


def phase_splat(dev, model, parents=()):
    """Row 1: the splat against its plain version at the coarse pass (the
    canonical camera's 128^2 rays x 48 stratified samples), a fine pass and
    the 'mir' two-camera pass of a full-width render, and the coarse points
    with an eighth moved onto two planes' edge and an eighth outside all
    three. Per shape:
    the reductions the kernel issues (distinct (tile, plane, texel) keys x
    channel groups, counted in plain PyTorch), device-only and back-to-back
    times, and the bound. Each parent checkout's kernel is timed in turns
    with this one."""
    import dataclasses

    import torch

    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools.splat_tiles import coarse_pass_points, render_points
    from spi_tpu_torch.tools.timing import device_ms, enqueue_us

    h = w = 256
    c = 32
    coarse = coarse_pass_points(dev)
    border = coarse.clone()
    q = coarse.shape[1] // 8
    border[0, :q] = torch.tensor([0.499, 0.0, 0.0], device=dev)  # on the edge of planes 0, 1
    border[0, q:2 * q] = torch.tensor([0.75, 0.75, 0.75], device=dev)  # outside all three
    geom = ps.RayGeom(1, 128, 128, 48)
    shapes = {"coarse": (coarse, geom), **render_points(dev, model), "border": (border, geom)}
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs, row = {}, None
    for label, (coords, geom) in shapes.items():
        p = coords.shape[1]
        g = torch.randn(1, 3, p, c, device=dev, generator=gen)
        got = ps.splat_cuda(coords, g, 1.0, h, w, geom)
        want = ps.splat_plain(coords, g, 1.0, h, w)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        max_abs = float((got - want).abs().max())
        reductions = ps.splat_tiled(coords, g, 1.0, h, w, geom)[1] * (c // 4)
        del got, want
        ms = time_ms(lambda: ps.splat_cuda(coords, g, 1.0, h, w, geom))
        dms = device_ms(lambda: ps.splat_cuda(coords, g, 1.0, h, w, geom))
        nbytes = g.numel() * 4 + coords.numel() * 4 + 3 * h * w * c * 4
        b_ms, b_by = bound_ms(nbytes, 3 * 4 * 2 * c * p)
        log(f"splat {label} (1, 3, {p}, {c}) {geom}: max abs err {max_abs:.3e}, rel {err:.3e} "
            f"(tol {TOL_SPLAT}); {reductions} reductions (one a corner: {3 * p * c}); "
            f"device-only {dms:.4f} ms, back-to-back {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.1f} MB)")
        check(err <= TOL_SPLAT, f"splat kernel disagrees with its plain version at {label}")
        if label != "border":
            inputs[label] = (coords, g, dataclasses.astuple(geom) if geom else None)
        if row is None:  # the table's row: the coarse pass
            host = enqueue_us(lambda: ps.splat_cuda(coords, g, 1.0, h, w, geom))
            plain = time_ms(lambda: ps.splat_plain(coords, g, 1.0, h, w), iters=5)
            plain_d = device_ms(lambda: ps.splat_plain(coords, g, 1.0, h, w), iters=5)
            # Yardstick: PyTorch's grid_sample backward on the same three
            # planes (NCHW input, (3, 1, P, 2) grid), input gradient only.
            grids = ps.project_onto_planes(coords * 2.0)[0][:, None]  # (3, 1, P, 2)
            inp = torch.zeros(3, c, h, w, device=dev)
            g_nchw = g[0].permute(0, 2, 1)[:, :, None, :].contiguous()  # (3, C, 1, P)

            def lib():
                return torch.ops.aten.grid_sampler_2d_backward(
                    g_nchw, inp, grids, 0, 0, False, [True, False])

            lib_ms, lib_d = time_ms(lib), device_ms(lib)
            log(f"splat coarse: host {host:.1f} us a call; plain {plain:.4f} ms (device-only "
                f"{plain_d:.4f}), grid_sampler_2d_backward {lib_ms:.4f} ms (device-only {lib_d:.4f})")
            row = {"max_abs_err": max_abs, "ms": ms, "device_ms": dms, "host_us": host,
                   "plain_ms": plain, "plain_device_ms": plain_d, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms, "library_device_ms": lib_d, "reductions": reductions}
            del grids, inp, g_nchw
    for parent in parents:
        turns(parent, "plane_splat", inputs)
    return {"name": "plane_splat", "route": "cuda", "source": "spi_tpu_torch/csrc/plane_splat.cu",
            "replaces": "spi_tpu/ops/plane_splat.py:113", **row}


def phase_bias_act(dev):
    import torch

    from spi_tpu_torch.ops.bias_act import (
        activation_funcs,
        bias_act_bwd_cuda,
        bias_act_fwd_cuda,
        bias_act_plain,
    )
    from spi_tpu_torch.tools.timing import device_ms

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
        dev_ms = [device_ms(fn) for fn in (
            lambda: bias_act_fwd_cuda(x, b, *cfg), lambda: bias_act_bwd_cuda(g, x, b, *cfg),
            lambda: bias_act_plain(x, b, dim=dim, act="lrelu", clamp=256.0 * spec.def_gain),
            plain_bwd)]
        c = shape[dim]
        fb = bound_ms(2 * n * 4 + c * 4, 4 * n)
        bb = bound_ms(3 * n * 4 + c * 4, 5 * n)
        log(f"bias_act lrelu {label} {tuple(shape)}: fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f},"
            f" bound {fb[0]:.4f}), bwd {bwd_ms:.4f} ms (plain fwd+bwd {bwd_plain:.4f}, "
            f"bound {bb[0]:.4f}); device-only: fwd {dev_ms[0]:.4f} (plain {dev_ms[2]:.4f}), "
            f"bwd {dev_ms[1]:.4f} (plain fwd+bwd {dev_ms[3]:.4f}) ms")
        rows[label] = {"fwd": (fwd_ms, fwd_plain, fb, dev_ms[0], dev_ms[2]),
                       "bwd": (bwd_ms, bwd_plain, bb, dev_ms[1], dev_ms[3])}
        del x, g
    out = []
    for name, line in (("fwd", 80), ("bwd", 96)):
        ms, plain, (b_ms, b_by), dms, plain_d = rows["block256"][name]
        out.append({"name": f"bias_act_{name}", "route": "cuda",
                    "source": "spi_tpu_torch/csrc/bias_act.cu",
                    "replaces": f"spi_tpu/ops/bias_act_pallas.py:{line}",
                    "max_abs_err": worst[f"bias_act_{name}"], "ms": ms, "device_ms": dms,
                    "plain_ms": plain, "plain_device_ms": plain_d, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "library_device_ms": None})
    return out


def phase_win_scatter(dev, parents=()):
    """Row 4: the windowed splat at the probe's shapes (384 tiles of 2048
    points, C = 32, into 256 x 256 x 32), K1 64x64 and 64x32 windows and
    K2 256x48 strips, in f32 and bf16. Per shape: the error against the
    plain version, the float4 reductions the kernel issues (nonzero bins,
    counted by win_scatter_binned), device-only and back-to-back times,
    the bound, and the bins' precomputed sums added onto the same table
    cells by row_scatter_add (rows of 32 channels, 8 lanes a cell). Then
    edge cases, each in f32 and bf16: a crowded window, every other tile
    dead, windows overhanging the table, and ragged tiles (2,500 points,
    12 channels). Each parent checkout's kernel is timed in turns with
    this one at the six probe shapes. The reductions alone, without the
    sums' bytes, and a block's time by phase: tools/winscatter_pace.py."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import row_scatter_add_cuda
    from spi_tpu_torch.ops.win_scatter import (
        win_scatter_binned,
        win_scatter_bins,
        win_scatter_cuda,
        win_scatter_plain,
    )
    from spi_tpu_torch.tools.probe_winscatter import C, H, N_TILES, TILE_P, W, WINDOWS, make_inputs
    from spi_tpu_torch.tools.timing import device_ms

    def compare(label, args, geom):
        got = win_scatter_cuda(*args, *geom)
        want = win_scatter_plain(*args, *geom)
        torch.cuda.synchronize()
        err, max_abs = rel_err(got, want), float((got - want).abs().max())
        check(err <= TOL_SCATTER, f"win_scatter {label} disagrees with its plain version: {err:.3e}")
        return err, max_abs

    worst, row, inputs = 0.0, None, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = "f32" if dtype == torch.float32 else "bf16"
        for name, win_h, win_w, spread in WINDOWS:
            args = make_inputs(N_TILES, win_h, win_w, spread if win_h != H else H - 2, spread,
                               dtype, device=dev, seed=4)
            geom = (win_h, win_w, H, W)
            label = f"{name} {dt}"
            err, max_abs = compare(label, args, geom)
            worst = max(worst, max_abs)
            reductions = win_scatter_binned(*args, *geom)[1]
            cells, sums = win_scatter_bins(*args, *geom)
            rows = cells.int()
            flush = device_ms(lambda: row_scatter_add_cuda(rows, sums, H * W))
            del cells, sums, rows
            dms = device_ms(lambda: win_scatter_cuda(*args, *geom))
            ms = time_ms(lambda: win_scatter_cuda(*args, *geom))
            # Bytes: the cotangents, the two coordinate rows of fyx that
            # are read, the offsets and the table; 12 operations a corner
            # and channel pair (hat weights and products) are far below.
            nbytes = (args[2].numel() * args[2].element_size() + 2 * N_TILES * TILE_P * 4
                      + args[0].numel() * 4 + H * W * C * 4)
            b_ms, b_by = bound_ms(nbytes, 12 * N_TILES * TILE_P * C)
            log(f"win_scatter {label}: max abs err {max_abs:.3e}, rel {err:.3e} (tol {TOL_SCATTER}); "
                f"{reductions} reductions; device-only {dms:.4f} ms, back-to-back {ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); the precomputed sums "
                f"added by row_scatter_add {flush:.4f} ms")
            inputs[label] = (*args, geom)
            if row is None:  # the table's row: K1 64x64 in f32
                plain = time_ms(lambda: win_scatter_plain(*args, *geom), iters=3)
                plain_d = device_ms(lambda: win_scatter_plain(*args, *geom), iters=3)
                log(f"win_scatter {label}: plain {plain:.4f} ms back-to-back, {plain_d:.4f} ms "
                    "device-only")
                row = {"ms": ms, "device_ms": dms, "plain_ms": plain, "plain_device_ms": plain_d,
                       "bound_ms": b_ms, "bound_by": b_by, "reductions": reductions,
                       "flush_device_ms": flush}
            del args
        gen = torch.Generator(device=dev).manual_seed(5)
        for case in ("crowded", "dead", "overhang", "ragged"):
            c, p = (12, 2500) if case == "ragged" else (C, TILE_P)
            offsets, fyx, g = make_inputs(64, 64, 64, 56, 56, dtype, tile_p=p, device=dev, seed=6,
                                          c=c)
            if case == "crowded":  # some 170 corners a cell
                fyx[:, :2] = torch.rand(64, 2, p, device=dev, generator=gen) * 6.0 + 20.0
            elif case == "dead":
                fyx[::2, :2] = -10.0
            elif case == "overhang":  # past the last row and column, and before the first
                offsets[::2] = torch.tensor([224, 232], dtype=torch.int32, device=dev)
                offsets[1::2] = torch.tensor([-40, -24], dtype=torch.int32, device=dev)
            err, max_abs = compare(f"{case} {dt}", (offsets, fyx, g), (64, 64, H, W))
            worst = max(worst, max_abs)
            log(f"win_scatter {case} {dt} (64 tiles of {p} points, C = {c}, 64x64 windows): "
                f"max abs err {max_abs:.3e}, rel {err:.3e} (tol {TOL_SCATTER})")
    for parent in parents:
        turns(parent, "win_scatter", inputs)
    return {"name": "win_scatter", "route": "cuda", "source": "spi_tpu_torch/csrc/win_scatter.cu",
            "replaces": "tools/probe_winscatter_r5.py:50", "max_abs_err": worst, **row,
            "library_ms": None, "library_device_ms": None}


def phase_row_gather(dev):
    """Row 5: the row gather at the probe's shape (65,536 rows of 32 f32)
    and at the render pass's (786,432 rows gathered from 65,536), with a
    row index broadcast over the columns (the probe's form), per-element
    indices, and per-element indices with some out of range. Bitwise equal
    to torch.gather where the index is in range, 0 elsewhere (where
    torch.gather would raise). Times of the broadcast form, device-only
    and back-to-back, beside torch.gather on int64 indices."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import row_gather_cuda, row_gather_plain
    from spi_tpu_torch.tools.timing import device_ms, enqueue_us

    gen = torch.Generator(device=dev).manual_seed(10)
    n_tab = 65536
    tab = torch.randn(n_tab, 32, device=dev, generator=gen)
    rows = {}
    for label, n in (("probe", 65536), ("render pass", 786432)):
        idx = torch.randint(0, n_tab, (n, 1), device=dev, generator=gen,
                            dtype=torch.int32).expand(n, 32).contiguous()
        per_element = torch.randint(0, n_tab, (n, 32), device=dev, generator=gen,
                                    dtype=torch.int32)
        outside = per_element.clone()
        outside[::7, 3] = n_tab
        outside[::5, :4] = -1
        outside[2::5] = n_tab + 5  # whole rows: the broadcast branch's range check
        for kind, ix in (("broadcast", idx), ("per-element", per_element),
                         ("out of range", outside)):
            got = row_gather_cuda(tab, ix)
            live = (ix >= 0) & (ix < n_tab)
            want = torch.gather(tab, 0, ix.clamp(0, n_tab - 1).long())
            torch.cuda.synchronize()
            equal = torch.equal(got[live], want[live]) and not bool(got[~live].any())
            log(f"row_gather {label} ({n}, 32) {kind}: {int((~live).sum())} indices out of "
                f"range; bitwise equal to torch.gather in range, 0 elsewhere: {equal}")
            check(equal, f"row_gather {label} {kind} differs from torch.gather")
        check(torch.equal(row_gather_cuda(tab, idx), row_gather_plain(tab, idx)),
              f"row_gather {label} differs from its plain version")
        idx64 = idx.long()
        t = {}
        for name, fn in (("kernel", lambda: row_gather_cuda(tab, idx)),
                         ("torch.gather", lambda: torch.gather(tab, 0, idx64)),
                         ("plain", lambda: row_gather_plain(tab, idx))):
            t[name] = (time_ms(fn), device_ms(fn), enqueue_us(fn))
        el64 = per_element.long()
        el = (device_ms(lambda: row_gather_cuda(tab, per_element)),
              device_ms(lambda: torch.gather(tab, 0, el64)))
        nbytes = 2 * idx.numel() * 4 + tab.numel() * 4
        b_ms, b_by = bound_ms(nbytes, 0)
        log(f"row_gather {label} broadcast: " + ", ".join(
            f"{k} {a:.4f} ms back-to-back, {d:.4f} ms device-only, host {u:.1f} us a call"
            for k, (a, d, u) in t.items())
            + f"; per-element device-only: kernel {el[0]:.4f} ms, torch.gather {el[1]:.4f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)")
        rows[label] = (t, b_ms, b_by)
    t, b_ms, b_by = rows["probe"]
    return {"name": "row_gather", "route": "cuda", "source": "spi_tpu_torch/csrc/row_gather.cu",
            "replaces": "tools/profile_gather.py:111", "max_abs_err": 0.0,
            "ms": t["kernel"][0], "device_ms": t["kernel"][1], "host_us": t["kernel"][2],
            "plain_ms": t["plain"][0], "plain_device_ms": t["plain"][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["torch.gather"][0],
            "library_device_ms": t["torch.gather"][1], "library_host_us": t["torch.gather"][2]}


def phase_row_scatter_add(dev):
    """Row 6: 786,432 rows of 32 f32 added into (65,536, 32) f32, the
    Pallas probe's shape; and the probe_scatter tool's 128 channels with
    0%, 50% and 90% of the rows out of range (dropped by the kernel)."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import row_scatter_add_cuda, row_scatter_add_plain
    from spi_tpu_torch.tools.timing import device_ms

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
            dms, plain_d, lib_d = (device_ms(fn) for fn in (
                lambda: row_scatter_add_cuda(rows, upd, n_out),
                lambda: row_scatter_add_plain(rows, upd, n_out),
                lambda: torch.zeros(n_out + 1, c, device=dev).index_add_(0, rows64, upd)))
            log(f"row_scatter_add ({n}, {c}): device-only kernel {dms:.4f} ms, plain "
                f"{plain_d:.4f} ms, index_add_ {lib_d:.4f} ms")
            row = {"ms": ms, "device_ms": dms, "plain_ms": plain, "plain_device_ms": plain_d,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                   "library_device_ms": lib_d}
        del upd, rows, rows64, got, want
    return {"name": "row_scatter_add", "route": "cuda",
            "source": "spi_tpu_torch/csrc/row_scatter_add.cu",
            "replaces": "tools/probe_scatter_r5.py:161", "max_abs_err": worst, **row}


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


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout (e.g. a git archive under build/) whose splat and "
                    "win_scatter kernels phase 2 times in turns with this one; may be given "
                    "more than once")
    args = ap.parse_args(argv)

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
    sass_atomics(path)
    model = build_model(dev)
    kernels = phase(2, "kernels vs plain", lambda: [
        phase_splat(dev, model, args.parent), *phase_bias_act(dev),
        phase_win_scatter(dev, args.parent),
        phase_row_gather(dev), phase_row_scatter_add(dev)])
    phase(3, "tiny synthesis card vs CPU", phase_tiny_synthesis, dev)
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
