#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernel library from spi_tpu_torch/csrc;
  2. hold each kernel against its plain PyTorch version on the card at
     the inversion path's shapes, and time kernel, plain version,
     PyTorch library yardstick and the roofline bound;
  3. tiny_test_config synthesis forward and w/noise gradients: on the
     card with the kernels versus on the CPU with the plain versions,
     same weights, same injected random draws;
  4. stage-1 'sg' projection at full ffhq512_128_config width (random
     seeded weights), a few steps, with every kernel's launch count;
  5. one more 'sg' step under torch.profiler: the card's time by kernel
     and by kind of kernel, and its busy share of a step.

Prints the card's name and power limit, one `{"kernels": [...]}` line,
and last `{"ok": true, "device": {...}}`. TF32 is off throughout: the
port computes in float32, as the JAX reference does.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM rate and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

TOL_SPLAT = 1e-4     # relative to max |ref|: f32 atomics add in run-dependent order
TOL_ELEMWISE = 1e-5  # absolute + relative: same f32 formulas, other libm approximations
TOL_SYNTH = 1e-3     # relative to max |ref|: card vs CPU, other summation orders end to end


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
            # Likewise where x + b is exactly 0: at that kink the kernel
            # takes act'(0) by the TPU kernel's rule (the x >= 0 branch),
            # PyTorch's relu, lrelu and selu the other branch.
            pre = bias_act_plain(x, b, dim=dim, act=act, gain=1.7)  # before the clamp
            near = ((pre.abs() - 2.5).abs() <= 1e-6) | (bias_act_plain(x, b, dim=dim) == 0)
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


def phase_tiny_synthesis(dev):
    """Card (kernels) vs CPU (plain versions) on tiny_test_config."""
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
                           {k: v.grad.cpu() for k, v in noise.items()}, launched)
    (ref_out, ref_gw, ref_gn, cpu_launched), (out, gw, gn, launched) = results["cpu"], results[dev]
    check(not any(cpu_launched.values()), f"CPU run launched kernels: {cpu_launched}")
    check(all(launched.values()), f"card run skipped a kernel: {launched}")
    errs = {k: rel_err(out[k], ref_out[k]) for k in ref_out}
    errs["grad_ws"] = rel_err(gw, ref_gw)
    errs["grad_noise"] = max(rel_err(gn[k], ref_gn[k]) for k in ref_gn)
    log("tiny synthesis card vs CPU, error relative to max |ref|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {TOL_SYNTH})")
    for k, v in errs.items():
        check(math.isfinite(v) and v <= TOL_SYNTH, f"tiny synthesis {k} disagrees: {v:.3e}")


def phase_project(dev, num_steps=8):
    """Stage-1 'sg' projection at full FFHQ-512 width. Returns the launch
    counts of the run, the model, and the median step time (s) of the
    steps after the second."""
    import torch

    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.training.projectors import ProjectorSettings, project
    from spi_tpu_torch.utils import camera as cam

    t0 = time.perf_counter()
    g = TriPlaneGenerator(ffhq512_128_config(), device=dev, seed=0)
    lpips = LPIPS(device=dev)
    target = torch.tanh(torch.randn(1, 3, 512, 512, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(7)))
    camera = cam.canonical_camera(device=dev)
    torch.cuda.synchronize()
    log(f"ffhq512_128: {sum(p.numel() for p in g.parameters())} generator parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    settings = ProjectorSettings(mode="sg", num_steps=num_steps, w_avg_samples=600)
    stamps, counts = [], []

    def on_step(step, dist):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        counts.append(dict(_lib.launch_counts))

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    t_start = time.perf_counter()
    w, noise, dists = project(g, lpips, target, camera, settings,
                              rng=torch.Generator(device=dev).manual_seed(8), device=dev,
                              on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(_lib.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    per_step = {k: counts[-1][k] - counts[-2][k] for k in launches}
    log(f"sg project: {num_steps} steps, first step {stamps[0] - t_start:.4f} s (with w stats), "
        f"then {[round(t, 5) for t in step_s]} s; median after the second {steady:.5f} s/step")
    log(f"sg project: peak device memory {peak / 2**30:.3f} GiB; dists {dists.tolist()}")
    log(f"sg project: launches {launches}; per step {per_step}")
    check(tuple(w.shape) == (1, g.num_ws, g.w_dim) and bool(torch.isfinite(w).all()),
          "w is not finite or has the wrong shape")
    check(bool(torch.isfinite(dists).all()), "a projection loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in noise.values()), "noise is not finite")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched on the main path")
    return launches, (g, lpips, target, camera), steady


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

    from spi_tpu_torch.training.projectors import ProjectorSettings, project

    g, lpips, target, camera = model
    settings = ProjectorSettings(mode="sg", num_steps=3, w_avg_samples=600)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        project(g, lpips, target, camera, settings,
                rng=torch.Generator(device=dev).manual_seed(9), device=dev,
                on_step=lambda step, dist: prof.step())
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from spi_tpu_torch.ops import _lib  # fails outside a checkout of the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path = _lib.build(verbose=True)
    _lib.lib()
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kernels = [phase_splat(dev), *phase_bias_act(dev)]
    log(f"phase 2: kernels vs plain done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_tiny_synthesis(dev)
    log(f"phase 3: tiny synthesis card vs CPU done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, model, steady_s = phase_project(dev)
    log(f"phase 4: sg projection done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_profile(dev, model, steady_s)
    log(f"phase 5: profile done in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]

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
