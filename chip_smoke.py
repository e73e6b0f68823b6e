#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent build/<dir> ...]

Phases (any failure exits non-zero):
  1. build the CUDA kernel library from spi_tpu_torch/csrc, and read its
     atomics from the SASS (no CAS-loop shared atomic anywhere);
  2. hold each kernel against its plain PyTorch version on the card at
     the shapes its path gives it (the splat also at a fine and a
     two-camera pass of a full-width render of phase 4's model; the
     triplane lookup bitwise at the splat's point sets and a GAN coarse
     pass, in float32 and bfloat16 planes; bias_act in float32 and in
     bfloat16), and time kernel, plain version and
     PyTorch library yardstick, both back-to-back and device-only
     (tools/timing.py), beside the roofline bound; row_scatter_add on
     both its routes, with the binned route's passes profiled, at four
     shapes and on clustered, one-row, negative, dead and empty rows; a
     Hessian-vector product through the lookup, card against CPU;
     upfirdn2d (row 8) forward, backward and double backward against
     upfirdn2d_plain at the callers' shapes (FIR_SHAPES), timed against its
     bytes bound, the plain version and ATen's depthwise convolution, and
     under vmap (one launch); the fused filtered_lrelu (row 9) forward (and
     its packed signs) and backward against its plain versions and the
     composition's kernels at StyleGAN3-T's largest layers (FLRELU_SHAPES),
     timed against its bound and the composition; with
     --parent, time each such checkout's splat, win_scatter and
     row_scatter_add kernels in turns with this one on the same inputs;
  3. tiny_test_config synthesis forward and w / noise / weight gradients:
     on the card with the kernels versus on the CPU with the plain
     versions, same weights, same injected random draws, in float32 and
     in bfloat16;
  4. stage-1 'sg' projection at full ffhq512_128_config width (random
     seeded weights), a few steps, with every kernel's launch count, and
     one more 'sg' step under torch.profiler, which must run no ATen
     depthwise convolution: float32 then bfloat16;
  6. stage-1 'mir' projection at full width from a yawed camera (two
     cameras rendered from one set of planes), float32 then bfloat16;
  7. stage-2 recon-only tuning at full width from phase 4's w and noise,
     float32 then bfloat16;
  8. the probe tools (spi_tpu_torch/tools), each run once;
  9. SPI's RotBbox stage 2 at full width from phase 4's w and noise, from
     a yawed camera with a synthetic face mask and landmarks: the
     regularizer steps' and the reconstruction steps' launches, and one
     regularizer step under torch.profiler (no ATen depthwise
     convolution), float32 then bfloat16;
 10. the inversion CLI end to end at full width on a synthetic identity
     written under build/ (both stages, SPI's RotBbox weights), its output
     tree, and a second run that reuses the first one's embedding: with
     --fp32, then without it (bfloat16, the CLI's default);
 11. preprocess at full width, float32: FAN (4 hourglass modules, 256^2),
     the ResNet-50 3DMM regressor (224^2, nonzero random heads) and BiSeNet
     (512^2), seeded random weights, each on the card against the CPU and
     timed; then cli/run_preprocess.py --random_init --mirror on one
     synthetic 640^2 photo (no failure allowed) and its crop/ c/ lm/ mask/
     tree;
 12. the user's path on that tree in bfloat16: the inversion CLI with
     --save_video (3 'mir' + 5 RotBbox steps), then cli/run_video.py with 8
     frames and a 128^3 shape export on the checkpoint it wrote: the video
     files, 8 finite 512^2 frames, a non-empty mesh and PLY, the frames a
     second and the shape's seconds (device probes, host marching
     tetrahedra), and the launches of one orbit chunk and one probe chunk;
 14. several images a step (parallel.spmd_invert): two images at full
     width in float32, 2 'mir' + 5 RotBbox steps, batched against one by
     one with the same per-image generators (w, LPIPS, steps, a tuned
     leaf), then with a threshold one of them reaches early;
 15. launches a step at B = 1, 2, 4 through the batched path ('sg' and a
     RotBbox cadence, float32 and bfloat16; a cell that does not fit the
     card is reported), which must equal B = 1's, and no ATen depthwise
     convolution in a profiled B = 4 step ('sg' in each dtype, a bf16
     RotBbox regularizer step);
 16. the inversion CLI with --parallel_images 4 on four synthetic
     identities in bfloat16;
 17. --dataset_block auto in two processes on the card (gloo, the
     environment torchrun sets), the tiny generator on three identities:
     the stripes and the global metric means;
 18. CLIP-guided editing at full width in float32: twin ffhq512_128_config
     generators and ViT-B/32 + ViT-B/16 at their published widths (seeded
     random weights), batch 2, the CLI's defaults (direction term only, the
     stand-in tokenizer): build_states' seconds, 6 ZSSGAN steps (launches
     a step of the splat and both bias_act kernels, which each step
     launches: the forward in both renders and the mapping, the backward
     and the splat in the trainable render's backward), only the masked
     leaves moved, the frozen twin bitwise unchanged, finite losses; one
     more step under torch.profiler (no ATen depthwise convolution); one
     --ide3d step, which must move ToRGB;
 19. the editing CLIs: cli/run_editing.py --random_init at full width (3
     steps, sample grids at steps 0 and 2, a final.npz with every generator
     key that loads into the port's TriPlaneGenerator; the splat and both
     bias_act kernels launched), then cli/generate_edit_videos.py at --size
     1024 on two seeded random 2D StyleGAN2 checkpoints written by the
     phase (four --ckpt, for the combined video's square grid), 8 unedited
     frames: the videos or their fallbacks, the bias_act forward kernel
     launched;
 20. EG3D GAN training at full width: ffhq512_128_config at nrr 64 in
     bfloat16 and DualDiscriminator(c_dim=25, img_resolution=512) in
     float32, seeded random, batch 8 (run_gan_training's default; 4 if 8
     does not fit, said on its own line), the ADA pipe at p = 0.2, a
     synthetic 512^2 batch at the canonical camera: 6 steps (step 0 with
     lazy R1 and density TV, step 4 with density TV) and a warm R1 step;
     launches a step (the splat and both bias_act kernels in both dtypes,
     and no second-order launch: D's activations are lrelu and linear),
     finite losses, every parameter that gets a gradient moved, G_ema
     moved less than G; then each kernel on the
     inputs of its largest call in an R1 + TV step (the splat's coarse
     pass, D's float32 bias_act forward and backward and the backward as
     R1's second order, G's bf16 forms) against its plain version, at
     phase 2's tolerances;
 21. cli/run_gan_training.py at full width on 16 synthetic 512^2 images
     with a dataset.json (4 steps, a tick and snapshot each): stats.jsonl,
     the snapshots, network-final.npz rendering through the port's
     TriPlaneGenerator; then the CLI's tiny trainer in two processes on the
     card (gloo): the CLI finds the replicas of G, D and G_ema bitwise
     equal at every snapshot and leaves the process group.
 22. converted weights: the seeded ffhq512_128_config generator written as an
     EG3D persistence pickle in both forms (pickle.dump, EG3D's own, and
     torch.save), each converted by `python -m spi_tpu_torch.convert eg3d`
     in a process of its own, every array equal to its source bitwise; the
     npz loaded into a fresh generator on the card, one float32 'sg' step's
     loss and gradient of w against the source module's on the same draws
     (TOL_SYNTH); then data/native_loader.py on the host (a prefetch batch
     equal to PIL's decode), where native/libspi_io.so loads;
 23. StyleGAN3-T FFHQ-1024 at its published widths (22,315,239 entries),
     float32, batch 1, seeded: a forward and a backward (finite, and the
     launches of each: one fused filtered_lrelu each way a layer, no
     upfirdn2d), the largest bias_act call's inputs kernel against plain
     version bitwise, and one magnitude EMA renewed;
 24. the editing step replayed as one CUDA graph (`step`) against the same
     step issued eagerly (`eager_step`), at the tiny size and at
     edit_clip_b2's and edit_sg3t_b2's widths: 5 steps from one seed, the
     losses and trained leaves within twice three eager runs' spread, the same
     generator state and launches a step; a capture and replays under
     torch.profiler list an eager step's kernels a replay.
There is no phase 5 or 13; the other phases keep the numbers that the
port's comments cite. Steps of the port are timed by benchmark/run.py
alone: this script checks the port on the card and times its kernels.
Phase 2 also holds the splat, the lookup (f32 and bf16 planes, bitwise)
and both bias_act kernels (f32 and bf16, a batched and a shared bias)
under torch.func.vmap against their plain versions under the same vmap
and a loop over the images: one launch each for the batch.
Phase 2 also holds bias_act's second-order kernel against its plain
version (every activation, with and without clamp, the kink row), a
double backward through `bias_act` on the card against the CPU (the
backward kernel as the backward of the backward, the second-order kernel
where act'' is not identically 0), and `_BiasActCudaGrad` under vmap (one
launch).
Phase 3 also holds a tiny StyleGAN3-T (14 layers, 32²) forward and backward
on the card against the CPU: the output and every gradient to TOL_SYNTH,
with bias_act_fwd and bias_act_bwd launched.
Phase 3 also holds one tiny GAN step (spi_tpu's tiny GAN trainer,
float32, R1 and density TV, the pipe at p = 0.5, the same draws) on the
card against the CPU: the R1 term, the losses and every D and G gradient
to TOL_SYNTH; the R1 step launches more backward kernels than a plain one.
Phase 3 also holds one tiny_test_config RotBbox step (all four
regularizers, the mirror term on) on the card against the CPU: its LPIPS
and every weight gradient, in both dtypes; and one tiny ZSSGAN step
(tiny_test_config twins with noise strengths 0.1, tiny_test_clip, batch
2, the same injected draws: z, each render's random noise maps and
renderer draws), which launches the splat and both bias_act kernels: the
loss and every trained leaf's gradient and value to TOL_SYNTH, every other
leaf bitwise unchanged on both.

Each path (phases 3, 4, 6, 7, 9, 10, 12, 14-23 and each tool) runs with
the launch counts set to 0 just before it and fails unless each kernel
it is meant to launch was launched: a bfloat16 path the bias_act
kernels' and the lookup's bf16 forms. The lookup runs once a render
pass: 2 a 'sg', 'mir' or recon-only step, 10 a RotBbox regularizer step,
4 a plain GAN step and 6 one with density TV.
Prints the card's name and power limit, one `{"kernels": [...]}` line
(the bf16 forms' launches from the bfloat16 'sg' run, the second-order
form's from phase 20, each kernel's launches in a plain GAN step as
`gan_launches` and in one SG3-T forward + backward as `sg3_launches`), and
last `{"ok":
true, "device": {...}}`. TF32 is off throughout, as the JAX reference
computes float32 in full.
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
# bf16 bias_act, kernel vs plain version: linear and lrelu bitwise (the same
# f32 operations in the same order, one rounding); the other activations
# within 1 bf16 ulp (other f32 libm approximations before the rounding).
# Where act' is formed from y by a difference that cancels as the
# activation saturates (tanh 1 - y^2, sigmoid y(1 - y), elu y + 1, selu
# y + lambda alpha), dx is also taken within TOL_SATURATED_DX * |g| * gain:
# there a few f32 ulps of y become many bf16 ulps of a small dx.
TOL_BF16_ULP = 1.0
# bias_act's inputs set x + b to exactly 0 along this row (every channel of
# the first element of dim 0, at position 0 of the trailing dims), so that
# act'(0) is compared: (0, :, 0, 0) of an NCHW tensor, (0, :) of (N, C).
KINK_ROW = (0, slice(None), 0, 0)
TOL_SATURATED_DX = 1e-5
SATURATING = ("tanh", "sigmoid", "elu", "selu")
# bf16 end to end, card vs CPU (as the CPU tests hold the port's bf16 to
# spi_tpu's): outputs within RMS_BF16 of each other, and each device's
# error against the CPU's float32 run within BF16_FACTOR times the CPU's
# own bf16 error (+ 1e-3 on outputs): the two round in other places.
RMS_BF16 = 0.05
BF16_FACTOR = 2.0

# The kernels each path is meant to launch.
INVERSION_KERNELS = ("plane_splat", "plane_sample", "bias_act_fwd", "bias_act_bwd", "upfirdn2d")
BF16_KERNELS = ("plane_splat", "plane_sample_bf16", "bias_act_fwd_bf16", "bias_act_bwd_bf16",
                "upfirdn2d_bf16")
PATH_KERNELS = {"float32": INVERSION_KERNELS, "bfloat16": BF16_KERNELS}
# The lookup kernel's form for a path's planes (the generator's compute dtype).
SAMPLE_KERNEL = {"float32": "plane_sample", "bfloat16": "plane_sample_bf16"}


def check_lookups(label, step, dtype, want):
    """Fail unless one step launched the lookup kernel `want` times (one
    a render pass)."""
    n = step[SAMPLE_KERNEL[dtype]]
    check(n == want, f"{label}: {n} {SAMPLE_KERNEL[dtype]} launches a step, not {want}")


def tag(dtype):
    """A label's suffix: none for float32 (the earlier slices' labels), ' bf16'."""
    return "" if dtype == "float32" else " bf16"
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
# argv[1] (plane_splat, win_scatter or row_scatter_add) device-only on the
# saved inputs (argv[2]) with this tree's timing module (argv[3]); a tree
# whose splat_cuda takes no geometry gets none.
TURN_CODE = """
import importlib.util, inspect, json, sys
import torch
kernel, saved, timing_path = sys.argv[1:4]
spec = importlib.util.spec_from_file_location("timing", timing_path)
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
if kernel == "plane_splat":
    from spi_tpu_torch.ops import plane_splat as mod
    takes_geom = "geom" in inspect.signature(mod.splat_cuda).parameters
    def call(coords, g, geom):
        extra = (mod.RayGeom(*geom),) if takes_geom and geom else ()
        return lambda: mod.splat_cuda(coords, g, 1.0, 256, 256, *extra)
elif kernel == "win_scatter":
    from spi_tpu_torch.ops import win_scatter as mod
    def call(offsets, fyx, gft, geom):
        return lambda: mod.win_scatter_cuda(offsets, fyx, gft, *geom)
else:
    from spi_tpu_torch.ops import gather_scatter as mod
    def call(rows, upd, n_out):
        return lambda: mod.row_scatter_add_cuda(rows, upd, n_out)
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
    shared memory compiles to), if a win_scatter or row_scatter_add
    kernel adds other than by REDG and integer ATOMS.ADD, or if the
    scatter-add's passes lack their integer ranks or its float4
    reductions."""
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
        if "win_scatter" in func or "row_scatter" in func:
            check(all(op.startswith(("REDG", "ATOMS.ADD")) for op in ops),
                  f"{func} adds other than by REDG and integer ATOMS.ADD: {ops}")
    scatter = {f: ops for f, ops in counts.items() if "row_scatter" in f}
    for part, want in (("row_scatter_count", "ATOMS.ADD"), ("row_scatter_sum", "ATOMS.ADD"),
                       ("row_scatter_sum", "REDG"), ("row_scatter_atomic", "REDG")):
        check(any(part in f and any(op.startswith(want) for op in ops)
                  for f, ops in scatter.items()), f"{part} has no {want}: {scatter}")
    return counts


def pass_points(dev, model):
    """The point sets of phase 2's triplane kernels, {label: ((1, P, 3)
    points, RayGeom or None)}: the coarse pass (the canonical camera's
    128^2 rays x 48 stratified samples), a fine pass and the 'mir'
    two-camera pass of a full-width render, the RotBbox rot term's
    four-camera coarse and fine passes, the TV loss's 2,000 free points
    (no ray geometry), and the coarse points with an eighth moved onto two
    planes' edge and an eighth outside all three ('border')."""
    import torch

    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools.splat_tiles import coarse_pass_points, render_points, rotbbox_points

    coarse = coarse_pass_points(dev)
    border = coarse.clone()
    q = coarse.shape[1] // 8
    border[0, :q] = torch.tensor([0.499, 0.0, 0.0], device=dev)  # on the edge of planes 0, 1
    border[0, q:2 * q] = torch.tensor([0.75, 0.75, 0.75], device=dev)  # outside all three
    geom = ps.RayGeom(1, 128, 128, 48)
    return {"coarse": (coarse, geom), **render_points(dev, model),
            **rotbbox_points(dev, model), "border": (border, geom)}


def phase_splat(dev, model, parents=()):
    """Row 1: the splat against its plain version at each of `pass_points`'
    sets. Per shape: the reductions the kernel issues (distinct (tile,
    plane, texel) keys x channel groups, counted in plain PyTorch),
    device-only and back-to-back times, and the bound. Each parent
    checkout's kernel is timed in turns with this one."""
    import dataclasses

    import torch

    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools.timing import device_ms, enqueue_us

    h = w = 256
    c = 32
    shapes = pass_points(dev, model)
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


GAN_POINTS = (8, 64, 48)  # a GAN coarse pass: batch 8, nrr 64 (64^2 rays), 48 samples


def touched_rows(coords, h, w, box_warp=1.0):
    """The distinct in-range corner rows of the (N, 3, H*W) tables that the
    lookup of (N, M, 3) points reads: what the data needs, for the bound."""
    import torch

    from spi_tpu_torch.ops import plane_splat as ps

    fx, fy = ps._plane_texels(coords, box_warp, h, w)  # (N * 3, M)
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    base = torch.arange(fx.shape[0], device=fx.device)[:, None] * (h * w)
    keys = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        keys.append((base + yi * w + xi)[valid])
    return int(torch.unique(torch.cat(keys)).numel())


def phase_plane_sample(dev, model):
    """Row 7: the lookup kernel (the forward of `sample_planes`) against
    `sample_planes_plain` with torch.equal, in float32 and bfloat16 planes,
    at each of `pass_points`' sets and at a GAN coarse pass (GAN_POINTS: 8
    tables of 64^2 rays x 48 samples, 1,572,864 points). Both compute the
    same IEEE-rounded operations in the same order, so any difference is a
    fault. Per set: device-only and back-to-back times, the bound (the
    coordinates, the distinct corner rows this set reads and the float32
    output, each once), the plain version's time and F.grid_sample's on
    the (N * 3, C, H, W) view of the planes with their projected grid (for
    bfloat16 planes, grid_sample's bfloat16 form: a bf16 grid and bf16
    output, the nearest single call). Returns the two rows of the kernels
    line (the coarse pass's numbers)."""
    import torch
    import torch.nn.functional as F

    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools.splat_tiles import coarse_pass_points
    from spi_tpu_torch.tools.timing import device_ms, enqueue_us

    h = w = 256
    c = 32
    n_gan, res_gan, s_gan = GAN_POINTS
    gan = coarse_pass_points(dev, res_gan, s_gan)
    sets = {label: pts for label, (pts, _) in pass_points(dev, model).items()}
    sets["GAN coarse"] = torch.cat([gan * (1.0 - 0.01 * i) for i in range(n_gan)])
    gen = torch.Generator(device=dev).manual_seed(2)
    tables = torch.randn(n_gan, 3, h * w, c, device=dev, generator=gen)
    rows = []
    for dtype, name in ((torch.float32, "plane_sample"), (torch.bfloat16, "plane_sample_bf16")):
        all_planes = tables.to(dtype)
        row, worst, device_sets = None, 0.0, {}
        for label, coords in sets.items():
            n, m, _ = coords.shape
            planes = all_planes[:n].contiguous()
            got = ps.sample_planes_cuda(planes, coords, 1.0)
            want = ps.sample_planes_plain(planes, coords, 1.0)
            torch.cuda.synchronize()
            equal = torch.equal(got, want)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            view = planes.reshape(n * 3, h, w, c).permute(0, 3, 1, 2)  # (N * 3, C, H, W)
            grid = ps.project_onto_planes(coords * 2.0).reshape(n * 3, 1, m, 2).to(dtype)

            def kernel():
                return ps.sample_planes_cuda(planes, coords, 1.0)

            def plain():
                return ps.sample_planes_plain(planes, coords, 1.0)

            def lib():
                return F.grid_sample(view, grid, mode="bilinear", padding_mode="zeros",
                                     align_corners=False)

            lib_diff = float((lib().float()[:, :, 0].permute(0, 2, 1).reshape(n, 3, m, c)
                              - got).abs().max())
            del got, want
            t = {"kernel": (time_ms(kernel), device_ms(kernel)),
                 "plain": (time_ms(plain, iters=5), device_ms(plain, iters=5)),
                 "grid_sample": (time_ms(lib), device_ms(lib))}
            touched = touched_rows(coords, h, w)
            esize = planes.element_size()
            nbytes = coords.numel() * 4 + touched * c * esize + n * 3 * m * c * 4
            b_ms, b_by = bound_ms(nbytes, n * m * 3 * (7 * c + 20))
            device_sets[label] = t["kernel"][1]
            log(f"{name} {label} ({n}, 3, {m}, {c}) {dtype}: bitwise equal to the plain version "
                f"{equal} (max abs err {err:.3e}; F.grid_sample within {lib_diff:.3e}); "
                + ", ".join(f"{k} {a:.4f} ms back-to-back, {d:.4f} ms device-only"
                            for k, (a, d) in t.items())
                + f"; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB: {touched} corner rows "
                f"of {n * 3 * h * w}); device-only at {100 * b_ms / t['kernel'][1]:.0f}% of it")
            check(equal, f"{name} differs from its plain version at {label}")
            # float32 only: grid_sample's weights round apart by an ulp or so;
            # its bfloat16 form rounds the grid to bf16, another function.
            check(dtype == torch.bfloat16 or lib_diff <= TOL_SPLAT * float(tables.abs().max()),
                  f"{name} and F.grid_sample disagree at {label}: {lib_diff:.3e}")
            if row is None:  # the table's row: the coarse pass
                host = enqueue_us(kernel)
                log(f"{name} coarse: host {host:.1f} us a call")
                row = {"ms": t["kernel"][0], "device_ms": t["kernel"][1], "host_us": host,
                       "plain_ms": t["plain"][0], "plain_device_ms": t["plain"][1],
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["grid_sample"][0],
                       "library_device_ms": t["grid_sample"][1]}
            del view, grid
        rows.append({"name": name, "route": "cuda", "source": "spi_tpu_torch/csrc/plane_sample.cu",
                     "replaces": "tools/profile_gather.py:111",
                     "xla_composition": "spi_tpu/models/rendering/renderer.py:104",
                     "max_abs_err": worst, **row, "device_ms_sets": device_sets})
        del all_planes
    return rows


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
        x[KINK_ROW[:x.ndim]] = -b  # one row of channels with x + b exactly 0
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
            # Where x + b is exactly 0, both take act'(0) of spi_tpu's
            # impl='xla' path (relu 0, selu lambda alpha), and are compared.
            pre = bias_act_plain(x, b, dim=dim, act=act, gain=1.7)  # before the clamp
            near = (pre.abs() - 2.5).abs() <= 1e-6
            del pre
            n_near = int(near.sum())
            check(n_near <= 1e-4 * x.numel(), f"{n_near} elements at the clamp for {act}")
            errs = {}
            for name, a, r in (("bias_act_fwd", y, yr),
                               ("bias_act_bwd", dx.masked_fill(near, 0), dxr.masked_fill(near, 0))):
                excess = float(((a - r).abs() - TOL_ELEMWISE * (1 + r.abs())).max())
                errs[name] = float((a - r).abs().max())
                worst[name] = max(worst[name], errs[name])
                check(excess <= 0, f"{name} {act} at {label} disagrees: "
                      f"max abs err {errs[name]:.3e}")
            log(f"bias_act {act:8s} {label:8s} {tuple(shape)}: fwd err {errs['bias_act_fwd']:.2e}, "
                f"bwd err {errs['bias_act_bwd']:.2e} ({n_near} elements at the clamp left out)")
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


def bf16_ulp(t):
    """The spacing of bfloat16 values at each entry of `t` (a float32 tensor
    of bf16 values): 2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    import torch

    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8).clamp_min(2.0 ** -133)


def phase_bias_act_bf16(dev):
    """Rows 2-3 in bfloat16: the kernels' bf16 forms against their plain
    versions (`bias_act_plain`, `bias_act_grad_plain`), all 9 activations,
    clamped (2.5) and not, gain 1.7: linear and lrelu bitwise, the others
    within TOL_BF16_ULP (the saturating activations' dx see
    TOL_SATURATED_DX); where an activation's f32 value lies within 1e-5 of
    the clamp, the two may mask the gradient apart, so those elements are
    left out of the backward's comparison and counted. Four cases: the
    StyleGAN2 block and the decoder shapes (16-byte aligned, 8 values a
    thread), `unaligned` (views one element into their buffers: the scalar
    form) and `tail` (n % 8 = 3: the 8-wide form's last elements). Then
    the times at the main path's activation, beside the bf16 bounds, and
    the scalar form's at the block shape beside the 8-wide form's."""
    import torch

    from spi_tpu_torch.ops.bias_act import (
        activation_funcs,
        bias_act_bwd_cuda,
        bias_act_fwd_cuda,
        bias_act_grad_plain,
        bias_act_plain,
    )
    from spi_tpu_torch.tools.timing import device_ms

    bf = torch.bfloat16
    # label: (shape, dim, offset in elements from the buffer's start)
    cases = {"block256": ((1, 128, 256, 256), 1, 0), "decoder": ((128 * 128 * 48, 64), 1, 0),
             "unaligned": ((1, 64, 128, 128), 1, 1), "tail": ((1, 5, 33, 31), 1, 0)}
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(shape, offset=0, scale=1.0):
        buf = torch.empty(math.prod(shape) + offset, device=dev, dtype=bf)
        t = buf[offset:].view(shape)
        t.copy_(torch.randn(*shape, device=dev, generator=gen) * scale)
        return t

    rows, worst = {}, {"bias_act_fwd_bf16": 0.0, "bias_act_bwd_bf16": 0.0}
    for label, (shape, dim, offset) in cases.items():
        x, g = randn(shape, offset, 3.0), randn(shape, offset)
        b = randn((shape[dim],))
        x[KINK_ROW[:x.ndim]] = -b  # one row of channels with x + b exactly 0
        if label == "unaligned":
            check(x.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0, "unaligned case is aligned")
        if label == "tail":
            check(x.numel() % 8 != 0, "tail case is a multiple of 8")
        bshape = [-1 if i == dim else 1 for i in range(x.ndim)]
        for act in sorted(activation_funcs):
            spec = activation_funcs[act]
            for clamp in (None, 2.5):
                cfg = (dim, spec.cuda_id, spec.def_alpha, 1.7, clamp)
                y = bias_act_fwd_cuda(x, b, *cfg)
                dx = bias_act_bwd_cuda(g, x, b, *cfg)
                yr = bias_act_plain(x, b, dim=dim, act=act, gain=1.7, clamp=clamp)
                dxr = bias_act_grad_plain(g, x, b, dim=dim, act=act, gain=1.7, clamp=clamp)
                torch.cuda.synchronize()
                errs = {"bias_act_fwd_bf16": float((y.float() - yr.float()).abs().max()),
                        "bias_act_bwd_bf16": float((dx.float() - dxr.float()).abs().max())}
                for k, v in errs.items():
                    worst[k] = max(worst[k], v)
                what = f"bf16 {act} clamp {clamp} at {label}"
                n_near = 0
                if act in ("linear", "lrelu"):
                    check(torch.equal(y, yr), f"bias_act_fwd_bf16 {what} is not bitwise")
                    check(torch.equal(dx, dxr), f"bias_act_bwd_bf16 {what} is not bitwise")
                    ulps = (0.0, 0.0)
                else:
                    dy = (y.float() - yr.float()).abs() / bf16_ulp(yr)
                    dd = (dx.float() - dxr.float()).abs()
                    ok = dd <= TOL_BF16_ULP * bf16_ulp(dxr)
                    if act in SATURATING:
                        ok |= dd <= TOL_SATURATED_DX * g.float().abs() * 1.7
                    if clamp is not None:
                        xb = (x + b.reshape(bshape)).float()
                        pre = spec.func(xb, spec.def_alpha) * 1.7
                        near = ((pre.abs() - clamp).abs() <= 1e-5 * clamp)
                        n_near = int(near.sum())
                        ok |= near
                        del xb, pre, near
                    ulps = (float(dy.max()), float((dd / bf16_ulp(dxr))[~ok].max())
                            if not bool(ok.all()) else 0.0)
                    check(ulps[0] <= TOL_BF16_ULP, f"bias_act_fwd_bf16 {what}: {ulps[0]} ulp")
                    check(bool(ok.all()), f"bias_act_bwd_bf16 {what}: {int((~ok).sum())} "
                          f"elements above tolerance, up to {ulps[1]} ulp")
                    check(n_near <= max(1e-4 * x.numel(), 1), f"{n_near} elements at the clamp, "
                          f"{what}")
                    del dy, dd, ok
                log(f"bias_act bf16 {act:8s} clamp {str(clamp):4s} {label:9s} {tuple(shape)}: "
                    f"fwd max abs err {errs['bias_act_fwd_bf16']:.2e} ({ulps[0]:.0f} ulp), "
                    f"bwd {errs['bias_act_bwd_bf16']:.2e} ({n_near} elements at the clamp "
                    f"left out)")
                del y, dx, yr, dxr
        if label in ("unaligned", "tail"):
            continue
        # Times with the main path's activation (lrelu, gain sqrt 2, clamp 256 * sqrt 2).
        spec = activation_funcs["lrelu"]
        clamp = 256.0 * spec.def_gain
        cfg = (dim, spec.cuda_id, spec.def_alpha, spec.def_gain, clamp)
        fns = [lambda: bias_act_fwd_cuda(x, b, *cfg), lambda: bias_act_bwd_cuda(g, x, b, *cfg),
               lambda: bias_act_plain(x, b, dim=dim, act="lrelu", clamp=clamp),
               lambda: bias_act_grad_plain(g, x, b, dim=dim, act="lrelu", clamp=clamp)]
        if label == "block256":
            # The scalar form on copies one element into their buffers.
            xu, gu = randn(shape, 1), randn(shape, 1)
            xu.copy_(x)
            gu.copy_(g)
            check(torch.equal(bias_act_fwd_cuda(xu, b, *cfg), fns[0]())
                  and torch.equal(bias_act_bwd_cuda(gu, xu, b, *cfg), fns[1]()),
                  "the scalar and 8-wide bf16 forms differ")
            fns += [lambda: bias_act_fwd_cuda(xu, b, *cfg),
                    lambda: bias_act_bwd_cuda(gu, xu, b, *cfg)]
        t = [time_ms(fn) for fn in fns]
        d = [device_ms(fn) for fn in fns]
        n, c = x.numel(), shape[dim]
        fb = bound_ms(2 * n * 2 + c * 2, 4 * n)
        bb = bound_ms(3 * n * 2 + c * 2, 5 * n)
        log(f"bias_act bf16 lrelu {label} {tuple(shape)}: fwd {t[0]:.4f} ms (plain {t[2]:.4f}, "
            f"bound {fb[0]:.4f}), bwd {t[1]:.4f} ms (plain {t[3]:.4f}, bound {bb[0]:.4f}); "
            f"device-only: fwd {d[0]:.4f} (plain {d[2]:.4f}), bwd {d[1]:.4f} (plain {d[3]:.4f}) ms")
        rows[label] = {"fwd": (t[0], t[2], fb, d[0], d[2]), "bwd": (t[1], t[3], bb, d[1], d[3])}
        if label == "block256":
            log(f"bias_act bf16 lrelu {label}, scalar form (unaligned): fwd {t[4]:.4f} ms, "
                f"bwd {t[5]:.4f} ms; device-only: fwd {d[4]:.4f}, bwd {d[5]:.4f} ms")
            rows["scalar"] = {"fwd": (t[4], d[4]), "bwd": (t[5], d[5])}
            del xu, gu
        del x, g
    out = []
    for name, line in (("fwd", 80), ("bwd", 96)):
        ms, plain, (b_ms, b_by), dms, plain_d = rows["block256"][name]
        dec = rows["decoder"][name]
        out.append({"name": f"bias_act_{name}_bf16", "route": "cuda",
                    "source": "spi_tpu_torch/csrc/bias_act.cu",
                    "replaces": f"spi_tpu/ops/bias_act_pallas.py:{line}",
                    "max_abs_err": worst[f"bias_act_{name}_bf16"], "ms": ms, "device_ms": dms,
                    "plain_ms": plain, "plain_device_ms": plain_d, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "library_device_ms": None,
                    "decoder_ms": dec[0], "decoder_device_ms": dec[3],
                    "decoder_bound_ms": dec[2][0], "scalar_ms": rows["scalar"][name][0],
                    "scalar_device_ms": rows["scalar"][name][1]})
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
    this one at the six probe shapes."""
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
    indices, and per-element indices with some negative or out of range.
    As take_along_axis: bitwise equal to torch.gather at the index, wrapped
    by R where it lies in [-R, 0), NaN where it lies outside [-R, R); and
    bitwise equal to the plain version, NaN for NaN. Times of the broadcast
    form, device-only and back-to-back, beside torch.gather on int64
    indices."""
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
        outside[::5, :4] = -1  # wraps to the last row
        outside[1::11, 5] = -n_tab - 3
        outside[2::5] = n_tab + 5  # whole rows: the broadcast branch's range check
        outside[3::5] = -n_tab  # whole rows wrapped to row 0: its vector load
        for kind, ix in (("broadcast", idx), ("per-element", per_element),
                         ("out of range", outside)):
            got = row_gather_cuda(tab, ix)
            wrapped = torch.where(ix < 0, ix + n_tab, ix)
            live = (wrapped >= 0) & (wrapped < n_tab)
            want = torch.gather(tab, 0, wrapped.clamp(0, n_tab - 1).long())
            torch.cuda.synchronize()
            equal = torch.equal(got[live], want[live]) and bool(got[~live].isnan().all())
            plain = row_gather_plain(tab, ix)
            same = (torch.equal(got.isnan(), plain.isnan())
                    and torch.equal(got.nan_to_num(0.0), plain.nan_to_num(0.0)))
            log(f"row_gather {label} ({n}, 32) {kind}: {int((ix < 0).sum())} indices negative, "
                f"{int((~live).sum())} out of range; bitwise equal to torch.gather at the "
                f"wrapped index, NaN out of range: {equal}; to the plain version: {same}")
            check(equal, f"row_gather {label} {kind} differs from torch.gather")
            check(same, f"row_gather {label} {kind} differs from its plain version")
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


# row_scatter_add's timed shapes, (label, C, share of the rows past the
# table): the Pallas probe's 786,432 x 32 and the probe_scatter tool's 128
# channels. Rows lie in range or past the end, none negative, so that a
# parent checkout's kernel reads them alike in turns.
SCATTER_SHAPES = (("x32", 32, 0.0), ("x128", 128, 0.0), ("x128 50% dead", 128, 0.5),
                  ("x128 90% dead", 128, 0.9))


def scatter_passes(fn):
    """Device ms of each pass of `fn`, one row_scatter_add call, by kernel
    name (row_scatter_count, _colscan, _place, _sum, _atomic), averaged
    over 5 calls under torch.profiler."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        m = re.search(r"row_scatter_(count|colscan|place|sum|atomic)", e.key)
        if m:
            passes[m.group(1)] = e.device_time_total / e.count / 1e3
    return passes


def phase_row_scatter_add(dev, parents=()):
    """Row 6: 786,432 rows of 32 f32 added into (65,536, 32) f32, the Pallas
    probe's shape, and the probe_scatter tool's 128 channels with 0%, 50%
    and 90% of the rows past the table (dropped). At each: the error
    against the plain version, the kernel's, the plain version's and
    index_add_'s (dead rows sent to a sink row) times back-to-back and
    device-only, and both routes' device-only times (the kernel takes the
    one scatter_route picks), and the bound. Then cases, each
    held on both routes to the plain version at TOL_SCATTER, with the
    binned route's parts and pieces (row_scatter_add_binned): one coarse
    pass's clustered texel rows (plane 1 of probe_scatter.realistic_texels,
    786,432 x 32), every row into one row, negative rows that wrap (and
    some below -R, dropped), the same rows less 999 (a count that is no
    whole number of chunks), every row dead, and no update. The one-row
    case adds integer-valued updates, so that every sum is exact and the
    kernel must equal the plain version bitwise: a 786,432-term f32 sum in
    the plain version's own atomics rounds by more than TOL_SCATTER. Each
    parent checkout's kernel is timed in turns with this one at the four
    shapes, the clustered rows and the one row."""
    import torch

    from spi_tpu_torch.ops.gather_scatter import (
        row_scatter_add_atomic_cuda,
        row_scatter_add_binned,
        row_scatter_add_binned_cuda,
        row_scatter_add_cuda,
        row_scatter_add_plain,
        scatter_route,
    )
    from spi_tpu_torch.tools.probe_scatter import realistic_texels
    from spi_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device=dev).manual_seed(11)
    n, n_out = 786432, 65536
    routes = {"binned": row_scatter_add_binned_cuda, "atomic": row_scatter_add_atomic_cuda}

    def compare(label, rows, upd, exact=False):
        """Both routes against the plain version; the largest abs error."""
        want = row_scatter_add_plain(rows, upd, n_out)
        stats = row_scatter_add_binned(rows, upd, n_out)[1]
        worst = 0.0
        for route, kernel in routes.items():
            got = kernel(rows, upd, n_out)
            torch.cuda.synchronize()
            max_abs, err = float((got - want).abs().max()), rel_err(got, want)
            worst = max(worst, max_abs)
            log(f"row_scatter_add {label} ({rows.numel()}, {upd.shape[1]}) -> ({n_out}, "
                f"{upd.shape[1]}), {route}: max abs err {max_abs:.3e}, rel {err:.3e} (tol "
                f"{'bitwise' if exact else TOL_SCATTER})" + (
                    f"; {stats['parts']} parts, {stats['pieces']} pieces, "
                    f"{stats['reductions']} reductions" if route == "binned" else ""))
            check(torch.equal(got, want) if exact else err <= TOL_SCATTER,
                  f"row_scatter_add {label} ({route}) disagrees with its plain version: {err:.3e}")
        return worst

    worst, row, shapes, inputs = 0.0, None, {}, {}
    upd128 = torch.randn(n, 128, device=dev, generator=gen)
    for label, c, dead in SCATTER_SHAPES:
        upd = upd128 if c == 128 else torch.randn(n, c, device=dev, generator=gen)
        rows = torch.randint(0, n_out, (n, 1), device=dev, generator=gen, dtype=torch.int32)
        n_dead = int(n * dead)
        rows[torch.randperm(n, device=dev, generator=gen)[:n_dead]] = n_out  # interleaved
        rows64 = rows.reshape(-1).long()
        worst = max(worst, compare(label, rows, upd))
        # index_add_ has no drop: the yardstick sends dead rows to a sink row.
        t = {name: (time_ms(fn), device_ms(fn)) for name, fn in (
            ("kernel", lambda: row_scatter_add_cuda(rows, upd, n_out)),
            ("plain", lambda: row_scatter_add_plain(rows, upd, n_out)),
            ("index_add_", lambda: torch.zeros(n_out + 1, c, device=dev).index_add_(0, rows64,
                                                                                    upd)))}
        by_route = {route: device_ms(lambda: kernel(rows, upd, n_out))
                    for route, kernel in routes.items()}
        passes = scatter_passes(lambda: row_scatter_add_binned_cuda(rows, upd, n_out))
        route = scatter_route(c, n_out, torch.cuda.get_device_properties(dev).L2_cache_size)
        # Bytes: the row ids, the live rows' updates and the table.
        nbytes = (n - n_dead) * c * 4 + rows.numel() * 4 + n_out * c * 4
        b_ms, b_by = bound_ms(nbytes, (n - n_dead) * c)
        log(f"row_scatter_add {label}, {int(dead * 100)}% of rows past the table, {route} "
            "route: " + ", ".join(
                f"{k} {a:.4f} ms back-to-back, {d:.4f} ms device-only" for k, (a, d) in t.items())
            + "; device-only by route: " + ", ".join(f"{k} {v:.4f} ms" for k, v in by_route.items())
            + "; the binned route's passes (profiled): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in passes.items())
            + f"; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB), device-only kernel at "
            f"{100 * b_ms / t['kernel'][1]:.0f}% of it")
        shapes[label] = {"route": route, "ms": t["kernel"][0], "device_ms": t["kernel"][1],
                         "plain_ms": t["plain"][0], "plain_device_ms": t["plain"][1],
                         "library_ms": t["index_add_"][0], "library_device_ms": t["index_add_"][1],
                         "bound_ms": b_ms, **{f"{k}_device_ms": v for k, v in by_route.items()},
                         "binned_passes_ms": passes}
        inputs[label] = (rows, upd, n_out)
        if row is None:  # the table's row: the Pallas probe's shape
            row = {"ms": t["kernel"][0], "device_ms": t["kernel"][1], "plain_ms": t["plain"][0],
                   "plain_device_ms": t["plain"][1], "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": t["index_add_"][0], "library_device_ms": t["index_add_"][1]}
        del rows, rows64
    upd = torch.randn(n, 32, device=dev, generator=gen)
    texels = torch.from_numpy(realistic_texels(dev, 48, 128)[1].reshape(-1)).int().to(dev)
    worst = max(worst, compare("clustered (one coarse pass, plane 1)", texels, upd))
    hot = torch.full((n,), 12345, device=dev, dtype=torch.int32)
    ints = torch.randint(-8, 8, (n, 32), device=dev, generator=gen).float()
    compare("every row into row 12345", hot, ints, exact=True)
    log("row_scatter_add device-only by route: " + "; ".join(
        f"{label} " + ", ".join(
            f"{route} {device_ms(lambda: kernel(r, u, n_out)):.4f} ms"
            for route, kernel in routes.items())
        for label, r, u in (("clustered", texels, upd), ("one row", hot, ints))))
    inputs.update({"clustered": (texels, upd, n_out), "one row": (hot, ints, n_out)})
    for parent in parents:
        turns(parent, "row_scatter_add", inputs)
    del inputs, upd128
    negative = torch.randint(-n_out - 4096, n_out, (n,), device=dev, generator=gen,
                             dtype=torch.int32)
    worst = max(worst, compare("negative rows (wrapped, some below -R)", negative, upd))
    ragged = n - 999  # not a whole number of the count pass's chunks
    worst = max(worst, compare("ragged (786,432 - 999 rows)", negative[:ragged], upd[:ragged]))
    dead = torch.where(negative < 0, negative - n_out - 4096, negative + n_out)
    compare("every row dead", dead, upd, exact=True)
    compare("no update", dead[:0], upd[:0], exact=True)
    return {"name": "row_scatter_add", "route": "cuda",
            "source": "spi_tpu_torch/csrc/row_scatter_add.cu",
            "replaces": "tools/probe_scatter_r5.py:161", "max_abs_err": worst, **row,
            "shapes": shapes}


# upfirdn2d's shapes (row 8): (label, x's shape, dtype, case). The cases
# are the callers': "fir" the FIR after each up block's transposed
# convolution (a 4x4 binomial, pad 1, gain 4), "skip" a ToRGB skip's
# upsample2d (up 2, pad (2, 1), gain 4), "sg3 up" / "sg3 down" the
# largest StyleGAN3-T filtered_lrelu's two FIRs (1-D Kaiser filters of 12
# taps). N = 16 is a RotBbox rot or mirror term's batch of images, 4 the
# reconstruction's, 2 the editing cell's.
FIR_SHAPES = (
    ("SR block1", (16, 128, 513, 513), "bfloat16", "fir"),
    ("SR block0", (16, 256, 257, 257), "bfloat16", "fir"),
    ("SR block1 skip", (16, 3, 256, 256), "bfloat16", "skip"),
    ("backbone 256", (4, 128, 257, 257), "bfloat16", "fir"),
    ("backbone skip", (4, 96, 128, 128), "bfloat16", "skip"),
    ("editing SR block1", (2, 128, 513, 513), "float32", "fir"),
    ("editing SR block0", (2, 256, 257, 257), "float32", "fir"),
    ("editing skip", (2, 96, 128, 128), "float32", "skip"),
    ("sg3 up", (1, 81, 1046, 1046), "float32", "sg3 up"),
    ("sg3 down", (1, 81, 2098, 2098), "float32", "sg3 down"),
)
# upfirdn2d, kernel vs plain version: float32 within TOL_FIR of the
# largest entry (the same products summed in another order; the separable
# form's 1-D taps also round apart from the 2-D products). bf16: one
# rounding of a float32 sum of the same exact products in another order,
# so every entry within TOL_BF16_ULP of the plain version's, beyond what
# the order can move the float32 sum where it cancels: 2 n 2^-24 times the
# sum of the n products' magnitudes (where the terms are large against
# their sum, a few float32 ulps of them are bf16 ulps of it).
TOL_FIR = 1e-6


def fir_case(case, dev):
    """(filter, up, down, padding, gain) of a FIR_SHAPES case."""
    from spi_tpu_torch.models.stylegan3 import design_lowpass_filter
    from spi_tpu_torch.ops.upfirdn2d import setup_filter

    if case in ("fir", "skip"):
        f = setup_filter([1, 3, 3, 1], device=dev)
        return (f, 1, 1, (1, 1, 1, 1), 4.0) if case == "fir" else (f, 2, 1, (2, 1, 2, 1), 4.0)
    f = design_lowpass_filter(numtaps=12, cutoff=256.0, width=2 * 148.0, fs=2 * 1024.0 * 2)
    f = setup_filter(f, device=dev)
    return (f, 2, 1, (9, 8, 9, 8), 4.0) if case == "sg3 up" else (f, 1, 2, (0, 0, 0, 0), 1.0)


def fir_agrees(label, got, want, dtype, magnitude, taps):
    """Check the kernel's result against the plain version's; return the
    largest error (relative to the largest entry in float32, in bf16 ulps
    of the plain version's entry in bfloat16). `magnitude`: each entry's
    sum of the magnitudes of its `taps` products (float32)."""
    if dtype == "float32":
        err = rel_err(got, want)
        check(err <= TOL_FIR, f"upfirdn2d {label}: {err:.3e} of the largest entry")
        return err
    diff = (got.float() - want.float()).abs()
    ulp = bf16_ulp(want)
    ulps = float((diff / ulp).max())
    order = 2 * taps * 2.0**-24 * magnitude
    within = bool((diff <= TOL_BF16_ULP * ulp + order).all())
    log(f"upfirdn2d {label}: {int((diff > TOL_BF16_ULP * ulp).sum())} of {diff.numel()} "
        f"entries over {TOL_BF16_ULP} bf16 ulp; all within it and the order term: {within}")
    check(within, f"upfirdn2d {label}: {ulps} bf16 ulps, beyond the float32 order term")
    return ulps


def phase_upfirdn2d(dev):
    """Row 8: upfirdn2d's kernel against `upfirdn2d_plain` on the card at
    each of FIR_SHAPES: the forward, the backward (the kernel on the
    adjoint problem against autograd of the plain version) and a double
    backward (the backward's gradient with respect to the cotangent);
    float32 within TOL_FIR of the largest entry, bf16 within TOL_BF16_ULP.
    Then device-only and back-to-back ms of the kernel forward and adjoint
    against the bytes bound (x read once, y written once), the plain
    version (forward; autograd's backward of it) and ATen's depthwise
    convolution alone on the padded input (its forward and input
    gradient), the library yardstick; and under vmap (B = 3 images of the
    SR block0 shape at N = 2) one launch, bitwise against a loop."""
    import importlib

    import torch
    import torch.nn.functional as F

    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.tools.timing import device_ms
    from spi_tpu_torch.utils.params import vmap_strict

    up2d = importlib.import_module("spi_tpu_torch.ops.upfirdn2d")
    gen = torch.Generator(device=dev).manual_seed(23)
    rows, worst = {}, {"float32": 0.0, "bfloat16": 0.0}
    for label, shape, dtype, case in FIR_SHAPES:
        dt = getattr(torch, dtype)
        f, up, down, pad, gain = fir_case(case, dev)
        args = ((up, up), (down, down), pad, False, gain)
        x = torch.randn(*shape, device=dev, generator=gen).to(dt).requires_grad_(True)
        _lib.reset_launch_counts()
        y = up2d.upfirdn2d(x, f, up, down, pad, gain=gain)
        check(_lib.launch_counts[up2d._COUNTS[dt]] == 1, f"upfirdn2d {label}: no launch")
        yp = up2d.upfirdn2d_plain(x, f, up, down, pad, gain=gain)
        g = torch.randn(y.shape, device=dev, generator=gen).to(dt)
        (dx,) = torch.autograd.grad(y, x, g)
        (dxp,) = torch.autograd.grad(yp, x, g)
        v = torch.randn(dx.shape, device=dev, generator=gen).to(dt)
        gk = g.detach().requires_grad_(True)
        (dxk,) = torch.autograd.grad(up2d.upfirdn2d(x, f, up, down, pad, gain=gain), x, gk,
                                     create_graph=True)
        (ddg,) = torch.autograd.grad(dxk, gk, v)
        gp = g.detach().requires_grad_(True)
        (dxq,) = torch.autograd.grad(up2d.upfirdn2d_plain(x, f, up, down, pad, gain=gain), x,
                                     gp, create_graph=True)
        (ddgp,) = torch.autograd.grad(dxq, gp, v)
        # Each entry's sum of its products' magnitudes, in float32.
        fa = f.abs()
        xa = x.detach().abs().float().requires_grad_(True)
        mag_y = up2d.upfirdn2d_plain(xa, fa, up, down, pad, gain=abs(gain))
        (mag_dx,) = torch.autograd.grad(mag_y, xa, g.abs().float())
        mag_ddg = up2d.upfirdn2d_plain(v.abs().float(), fa, up, down, pad, gain=abs(gain))
        taps = math.prod(up2d.filter_size(f)) // up**2
        torch.cuda.synchronize()
        errs = [fir_agrees(f"{label} {kind}", a.detach(), b.detach(), dtype, m.detach(), t)
                for kind, a, b, m, t in (("forward", y, yp, mag_y, taps),
                                         ("backward", dx, dxp, mag_dx, taps * up**2 // down**2),
                                         ("double backward", ddg, ddgp, mag_ddg, taps))]
        del fa, xa, mag_y, mag_dx, mag_ddg
        worst[dtype] = max(worst[dtype], *errs)
        unit = "of the largest entry" if dtype == "float32" else "bf16 ulps"
        log(f"upfirdn2d {label} {shape} {dtype} {case}: forward {errs[0]:.3g}, backward "
            f"{errs[1]:.3g}, double backward {errs[2]:.3g} {unit}")
        del y, yp, dx, dxp, v, gk, dxk, ddg, gp, dxq, ddgp
        xd, gd = x.detach(), g
        fw, fh = up2d.filter_size(f)
        oh, ow = gd.shape[2:]
        adj = (fw - pad[0] - 1, shape[3] * up - ow * down + pad[0] - up + 1,
               fh - pad[2] - 1, shape[2] * up - oh * down + pad[2] - up + 1)
        # ATen's depthwise call alone, on the padded (zero-upsampled) input.
        xpad = up2d.upfirdn2d_plain(xd, None, up, 1, pad).detach()
        w = (f.flip([0, 1]) if f.ndim == 2 else torch.outer(f, f).flip([0, 1])) * gain
        w = w.to(dt)[None, None].repeat(shape[1], 1, 1, 1)
        xpr = xpad.requires_grad_(True)
        yl = F.conv2d(xpr, w, stride=down, groups=shape[1])
        xr = xd.detach().requires_grad_(True)
        ypl = up2d.upfirdn2d_plain(xr, f, up, down, pad, gain=gain)
        fns = {
            "kernel forward": lambda: up2d.upfirdn2d_cuda(xd, f, *args),
            "kernel adjoint": lambda: up2d.upfirdn2d_cuda(gd, f, args[1], args[0], adj, True,
                                                          gain),
            "plain forward": lambda: up2d.upfirdn2d_plain(xd, f, up, down, pad, gain=gain),
            "plain backward": lambda: torch.autograd.grad(ypl, xr, gd, retain_graph=True),
            "library forward": lambda: F.conv2d(xpad, w, stride=down, groups=shape[1]),
            "library backward": lambda: torch.autograd.grad(yl, xpr, gd, retain_graph=True),
        }
        ms = {k: (time_ms(fn), device_ms(fn)) for k, fn in fns.items()}
        nbytes = (xd.numel() + gd.numel()) * xd.element_size()
        b_ms, b_by = bound_ms(nbytes, 0)
        log(f"upfirdn2d {label}: bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB); "
            + ", ".join(f"{k} {a:.4f} ms back-to-back, {d:.4f} device-only"
                        f"{f' ({100 * b_ms / d:.1f}% of the bound)' if 'kernel' in k else ''}"
                        for k, (a, d) in ms.items()))
        rows[label] = (ms, b_ms, b_by)
        del x, g, xd, gd, xpad, xpr, yl, xr, ypl, fns
        torch.cuda.empty_cache()

    # Under vmap: B images of the editing cell's block0 shape, one launch.
    f, up, down, pad, gain = fir_case("fir", dev)
    xs = torch.randn(3, 2, 256, 257, 257, device=dev, generator=gen).to(torch.bfloat16)

    def fir(x):
        return up2d.upfirdn2d(x, f, up, down, pad, gain=gain)

    _lib.reset_launch_counts()
    got = vmap_strict(fir)(xs)
    n = _lib.launch_counts["upfirdn2d_bf16"]
    same = torch.equal(got, torch.stack([fir(x) for x in xs]))
    log(f"upfirdn2d under vmap B=3 {tuple(xs.shape)} bf16: {n} launch; bitwise the loop: {same}")
    check(n == 1 and same, "upfirdn2d under vmap")
    del xs, got
    torch.cuda.empty_cache()

    out = []
    for name, label, dtype in (("upfirdn2d", "editing SR block1", "float32"),
                               ("upfirdn2d_bf16", "SR block1", "bfloat16")):
        ms, b_ms, b_by = rows[label]
        out.append({"name": name, "route": "cuda", "source": "spi_tpu_torch/csrc/upfirdn2d.cu",
                    "replaces": None, "max_abs_err": worst[dtype], "shape": label,
                    "ms": ms["kernel forward"][0], "device_ms": ms["kernel forward"][1],
                    "adjoint_ms": ms["kernel adjoint"][0],
                    "adjoint_device_ms": ms["kernel adjoint"][1],
                    "plain_ms": ms["plain forward"][0],
                    "plain_device_ms": ms["plain forward"][1], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": ms["library forward"][0],
                    "library_device_ms": ms["library forward"][1]})
    return out


# filtered_lrelu's shapes (row 9): (label, StyleGAN3-T FFHQ-1024 layer, x's
# shape) at the editing cell's batch of 2: L10 (up 4, 24 taps: 534^2 ->
# 2098^2 -> 1044^2), L11 (up 2, 12 taps: 1046^2 -> 2098^2 -> 1044^2) and the
# identity ToRGB layer (no filters, slope 1, gain 1).
FLRELU_SHAPES = (("L10", 10, (2, 81, 534, 534)), ("L11", 11, (2, 51, 1046, 1046)),
                 ("ToRGB", 14, (2, 3, 1024, 1024)))
# The fused kernels against their plain versions: float32 within TOL_FLRELU
# of the largest entry (two FIRs in a row, each in other sums: the plain
# version's 2-D taps are float32 roundings of the 1-D taps' products, its
# convolution adds in its own order; against TOL_FIR's one FIR), against
# the composition's kernels within TOL_FIR (the same separable sums in the
# same order, but for db's reduction); a sign byte may
# differ only where the plain u lies within TOL_SIGN of 0 (of its largest
# entry) or lrelu(u) * gain within TOL_SIGN of the clamp (relative), where
# the two sums round to either side.
TOL_SIGN = 1e-5
TOL_FLRELU = 4e-6


def sg3_layer_args(dev, index):
    """(fu, fd, up, down, padding, gain, slope, clamp) of StyleGAN3-T
    FFHQ-1024's layer `index` (its filters on `dev`)."""
    from spi_tpu_torch.models.stylegan3 import SG3SynthesisNetwork

    net = SG3SynthesisNetwork(SG3_T["w_dim"], SG3_T["img_resolution"], SG3_T["img_channels"],
                              device="cpu")
    layer = getattr(net, net.layer_names[index])
    fu, fd = (None if f is None else f.to(dev) for f in (layer.up_filter, layer.down_filter))
    return (fu, fd, layer.up_factor, layer.down_factor, tuple(layer.padding),
            1.0 if layer.is_torgb else math.sqrt(2.0), 1.0 if layer.is_torgb else 0.2,
            float(layer.conv_clamp))


def phase_filtered_lrelu(dev):
    """Row 9: the fused filtered_lrelu kernels against their plain versions
    on the card at FLRELU_SHAPES: the forward (output, and the packed
    signs bitwise but at ties, TOL_SIGN), the backward from the kernel's
    signs (dx and db) against `filtered_lrelu_bwd_plain` on the same
    signs (TOL_FLRELU of the largest entry), and against autograd of
    `filtered_lrelu_composed` (the two bias_act and two upfirdn2d kernels;
    TOL_FIR). Then device-only and back-to-back ms of the kernels
    (forward without and with signs; backward with the bias gradient)
    against the bound (benchmark/counts' bytes and operations) and against
    the composition's kernels, forward and backward."""
    import importlib

    import torch

    from benchmark.counts import stylegan3 as counts
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.tools.timing import device_ms

    FL = importlib.import_module("spi_tpu_torch.ops.filtered_lrelu")
    gen = torch.Generator(device=dev).manual_seed(29)
    worst = {"filtered_lrelu_fwd": 0.0, "filtered_lrelu_bwd": 0.0, "filtered_lrelu_bias_grad": 0.0}
    rows = {}
    for label, index, shape in FLRELU_SHAPES:
        fu, fd, up, down, pad, gain, slope, clamp = sg3_layer_args(dev, index)
        cfg = (up, down, pad, gain, slope)
        # Scaled so that some values clamp.
        x = torch.randn(*shape, device=dev, generator=gen) * 40.0
        b = torch.randn(shape[1], device=dev, generator=gen)
        _lib.reset_launch_counts()
        y, signs = FL.filtered_lrelu_fwd_cuda(x, fu, fd, b, up, down, pad, gain, slope, clamp,
                                              False, True)
        check(_lib.launch_counts["filtered_lrelu_fwd"] == 1, f"filtered_lrelu {label}: no launch")
        yp, sp = FL.filtered_lrelu_fwd_plain(x, fu, fd, b, up, down, pad, gain, slope, clamp,
                                             False)
        err_y = rel_err(y, yp)
        differ = signs != sp
        n_differ = int(differ.sum())
        if n_differ:
            u = FL.upfirdn2d_plain(x + b[None, :, None, None], fu, up=up, padding=pad,
                                   gain=up**2)
            v = torch.where(u >= 0, u, u * slope).abs() * gain
            near = (u.abs() <= TOL_SIGN * float(u.abs().max())) | (
                (v - clamp).abs() <= TOL_SIGN * clamp)
            near = FL.pack_signs(near, near) != 0
            check(bool((~differ | near).all()), f"filtered_lrelu {label}: sign bytes differ away "
                                                "from a tie")
            del u, v, near
        del yp, sp, differ
        dy = torch.randn(y.shape, device=dev, generator=gen)
        dx, db = FL.filtered_lrelu_bwd_cuda(dy, signs, fu, fd, shape[2:], *cfg, False, True)
        dxp, dbp = FL.filtered_lrelu_bwd_plain(dy, signs, fu, fd, shape[2:], *cfg, False)
        err_dx, err_db = rel_err(dx, dxp), rel_err(db, dbp)
        del dxp, dbp
        xr, br = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        yc = FL.filtered_lrelu_composed(xr, fu, fd, br, up, down, pad, gain, slope, clamp, False)
        dxc, dbc = torch.autograd.grad(yc, (xr, br), dy, retain_graph=True)
        err_c = [rel_err(y, yc.detach()), rel_err(dx, dxc), rel_err(db, dbc)]
        del dxc, dbc
        log(f"filtered_lrelu {label} {shape} up {up} down {down}: kernel vs plain version, of the "
            f"largest entry: y {err_y:.2e}, dx {err_dx:.2e}, db {err_db:.2e}; sign bytes "
            f"differing at ties {n_differ} of {signs.numel()}; vs the composition's kernels "
            f"(autograd): y {err_c[0]:.2e}, dx {err_c[1]:.2e}, db {err_c[2]:.2e} (tol "
            f"{TOL_FLRELU}, {TOL_FIR})")
        check(max(err_y, err_dx, err_db) <= TOL_FLRELU and max(err_c) <= TOL_FIR,
              f"filtered_lrelu {label} disagrees")
        worst["filtered_lrelu_fwd"] = max(worst["filtered_lrelu_fwd"], err_y)
        worst["filtered_lrelu_bwd"] = max(worst["filtered_lrelu_bwd"], err_dx)
        worst["filtered_lrelu_bias_grad"] = max(worst["filtered_lrelu_bias_grad"], err_db)
        lib = _lib.lib()
        tiles = lib.spi_filtered_lrelu_bwd_tiles(up, down, shape[2], shape[3])
        part = torch.randn(shape[0] * shape[1] * tiles, device=dev, generator=gen)
        dbk = torch.empty_like(b)
        stream = _lib.stream_handle(dev)
        fns = {
            "kernel forward": lambda: FL.filtered_lrelu_fwd_cuda(x, fu, fd, b, *cfg, clamp, False,
                                                                 False),
            "kernel forward + signs": lambda: FL.filtered_lrelu_fwd_cuda(
                x, fu, fd, b, *cfg, clamp, False, True),
            "kernel backward + db": lambda: FL.filtered_lrelu_bwd_cuda(
                dy, signs, fu, fd, shape[2:], *cfg, False, True),
            "bias_grad kernel": lambda: lib.spi_filtered_lrelu_bias_grad(
                part.data_ptr(), dbk.data_ptr(), shape[0], shape[1], tiles, stream),
            "plain forward": lambda: FL.filtered_lrelu_fwd_plain(x, fu, fd, b, *cfg, clamp, False),
            "composition forward": lambda: FL.filtered_lrelu_composed(
                x, fu, fd, b, up, down, pad, gain, slope, clamp, False),
            "composition backward": lambda: torch.autograd.grad(yc, (xr, br), dy,
                                                                retain_graph=True),
        }
        ms = {k: (time_ms(fn), device_ms(fn)) for k, fn in fns.items()}
        up_h = FL._sizes(shape[2], shape[3], FL.filter_size(fu), FL.filter_size(fd), up, down,
                         pad)[0]
        call = counts.FilteredLReLU(shape[0], shape[1], shape[2], up_h, y.shape[2], up,
                                    FL.filter_size(fu)[0], FL.filter_size(fd)[0], True)
        ops, fwd_by, bwd_by = counts.flops(call), counts.fwd_bytes(call), counts.bwd_bytes(call)
        bounds = {"forward": bound_ms(fwd_by, ops), "backward": bound_ms(bwd_by, ops)}
        log(f"filtered_lrelu {label}: bound forward {bounds['forward'][0]:.4f} ms "
            f"({bounds['forward'][1]}, {ops / 1e9:.2f} GFLOP, {fwd_by / 1e6:.1f} MB), backward "
            f"{bounds['backward'][0]:.4f} ms; " + ", ".join(
                f"{k} {a:.4f} ms back-to-back, {d:.4f} device-only" + (
                    f" ({100 * bounds['backward' if 'backward' in k else 'forward'][0] / d:.1f}% "
                    "of the bound)" if k.startswith("kernel") else "")
                for k, (a, d) in ms.items()))
        rows[label] = (ms, bounds)
        del x, b, y, signs, dy, dx, db, xr, br, yc, part, fns
        torch.cuda.empty_cache()

    ms, bounds = rows["L10"]
    common = {"route": "cuda", "source": "spi_tpu_torch/csrc/filtered_lrelu.cu", "replaces": None,
              "shape": "L10", "library_ms": None, "library_device_ms": None}
    return [
        {"name": "filtered_lrelu_fwd", **common, "max_abs_err": worst["filtered_lrelu_fwd"],
         "ms": ms["kernel forward + signs"][0], "device_ms": ms["kernel forward + signs"][1],
         "plain_ms": ms["plain forward"][0], "plain_device_ms": ms["plain forward"][1],
         "composition_ms": ms["composition forward"][0],
         "composition_device_ms": ms["composition forward"][1],
         "bound_ms": bounds["forward"][0], "bound_by": bounds["forward"][1]},
        {"name": "filtered_lrelu_bwd", **common, "max_abs_err": worst["filtered_lrelu_bwd"],
         "ms": ms["kernel backward + db"][0], "device_ms": ms["kernel backward + db"][1],
         "plain_ms": None, "plain_device_ms": None,
         "composition_ms": ms["composition backward"][0],
         "composition_device_ms": ms["composition backward"][1],
         "bound_ms": bounds["backward"][0], "bound_by": bounds["backward"][1]},
        {"name": "filtered_lrelu_bias_grad", **common,
         "max_abs_err": worst["filtered_lrelu_bias_grad"], "ms": ms["bias_grad kernel"][0],
         "device_ms": ms["bias_grad kernel"][1], "plain_ms": None, "plain_device_ms": None,
         "bound_ms": None, "bound_by": None},
    ]


def phase_lookup_hvp(dev):
    """A Hessian-vector product through `sample_planes`: H v of
    sum(sample_planes(p, x) ** 2) with respect to full-width planes (256^2
    x 32, random) at the first 8 ray rows of the coarse pass (49,152
    points), on the card against the CPU, to TOL_SPLAT of the largest
    entry (the splat's f32 reductions add in any order). The double
    backward must launch the lookup once (the splat's own backward) and
    the splat once."""
    import torch

    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools.splat_tiles import coarse_pass_points

    gen = torch.Generator().manual_seed(12)
    planes = torch.randn(1, 3, 256 * 256, 32, generator=gen)
    v = torch.randn(planes.shape, generator=gen)
    geom = ps.RayGeom(1, 8, 128, 48)
    coords = coarse_pass_points(dev)[:, :geom.n_points].cpu()

    def hvp(device):
        p = planes.to(device).requires_grad_(True)
        out = ps.sample_planes(p, coords.to(device), 1.0, geom)
        (g,) = torch.autograd.grad(out.square().sum(), p, create_graph=True)
        _lib.reset_launch_counts()
        (h,) = torch.autograd.grad((g * v.to(device)).sum(), p)
        return h, dict(_lib.launch_counts)

    card, launches = hvp(dev)
    cpu, _ = hvp(torch.device("cpu"))
    err = rel_err(card.cpu(), cpu)
    log(f"Hessian-vector product through the lookup ({geom.n_points} points, 256^2 x 32 "
        f"planes): rel err card vs CPU {err:.3e} (tol {TOL_SPLAT}); double backward launched "
        f"plane_sample {launches['plane_sample']}, plane_splat {launches['plane_splat']}")
    check(err <= TOL_SPLAT, f"the card's Hessian-vector product disagrees with the CPU's: {err}")
    check(launches["plane_sample"] == 1 and launches["plane_splat"] == 1,
          f"the double backward launched {launches}, not one lookup and one splat")


def tiny_synthesis(device, dtype):
    """tiny_test_config synthesis forward and backward on `device` in
    compute dtype `dtype`: the same seeded weights (nonzero noise
    strengths), w, noise maps and injected renderer draws on any device.
    Returns ({output: tensor}, {'grad_ws', 'grad_noise/<map>': tensor},
    {weight: gradient}, launches), all on the CPU."""
    import torch

    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils import camera as cam
    from spi_tpu_torch.utils.params import extract_noise, replace_noise

    cfg = tiny_test_config(compute_dtype=dtype)
    gen = torch.Generator().manual_seed(3)
    m = cfg.neural_rendering_resolution ** 2
    draws = {
        "stratified": torch.rand(1, m, cfg.rendering.depth_resolution, 1, generator=gen),
        "exponential": torch.empty(m, cfg.rendering.depth_resolution_importance + 1)
        .exponential_(generator=gen),
    }
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
    check(all(v.dtype == torch.float32 for v in out.values()), f"{dtype} outputs not float32")
    grads = {"grad_ws": ws.grad.cpu(),
             **{f"grad_noise/{k}": v.grad.cpu() for k, v in noise.items()}}
    return ({k: v.detach().cpu() for k, v in out.items()}, grads,
            {k: p.grad.cpu() for k, p in g.named_parameters() if p.grad is not None}, launched)


def check_bf16(label, card, cpu, ref, rms_bound=None):
    """bf16 on the card against bf16 on the CPU, each against the CPU's
    float32 run `ref` ({name: tensor}), relative to each tensor's largest
    entry: the largest and the median of those errors on the card at most
    BF16_FACTOR times the CPU's (+ 1e-3). rms_bound: also the RMS of card
    minus CPU at most that, tensor by tensor (outputs)."""
    import statistics

    e_card = {k: rel_err(card[k], ref[k]) for k in ref}
    e_cpu = {k: rel_err(cpu[k], ref[k]) for k in ref}
    worst = sorted(((e, k) for k, e in e_card.items()), reverse=True)
    stats = {"max": (worst[0][0], max(e_cpu.values())),
             "median": (statistics.median(e_card.values()), statistics.median(e_cpu.values()))}
    log(f"{label} bf16 error against the CPU's float32, relative to each tensor's max: "
        + ", ".join(f"{s} card {a:.3e} / CPU {b:.3e}" for s, (a, b) in stats.items())
        + f" over {len(ref)} tensors; the card's worst "
        + ", ".join(f"{k} {e:.2e}" for e, k in worst[:3]))
    for s, (a, b) in stats.items():
        check(math.isfinite(a) and a <= BF16_FACTOR * b + 1e-3,
              f"{label} bf16 {s} error {a:.3e} above {BF16_FACTOR} x the CPU's {b:.3e}")
    if rms_bound is not None:
        for k in ref:
            rms = float((card[k] - cpu[k]).square().mean().sqrt())
            log(f"{label} bf16 {k}: rms card - CPU {rms:.3e} (bound {rms_bound})")
            check(rms <= rms_bound, f"{label} bf16 {k}: rms {rms:.3e} above {rms_bound}")


def phase_tiny_synthesis(dev):
    """Card (kernels) vs CPU (plain versions) on tiny_test_config: the
    outputs and the gradients of w, the noise maps and every weight (the
    weight gradients cross each bias_act kernel's bias path and the splat
    into the planes, as stage-2 tuning does). float32 to TOL_SYNTH; then
    bfloat16 by check_bf16, with bias_act launched in bf16."""
    runs = {(d, t): tiny_synthesis(d, t) for d in ("cpu", dev) for t in ("float32", "bfloat16")}
    for (d, t), (*_, launched) in runs.items():
        if d == "cpu":
            check(not any(launched.values()), f"CPU {t} run launched kernels: {launched}")
        else:
            check(all(launched[k] for k in PATH_KERNELS[t]),
                  f"card {t} run skipped a kernel: {launched}")
    ref_out, ref_g, ref_gp, _ = runs[("cpu", "float32")]
    out, grads, gp, _ = runs[(dev, "float32")]
    check(set(gp) == set(ref_gp), "the card and the CPU give gradients to other weights")
    errs = {k: rel_err(out[k], ref_out[k]) for k in ref_out}
    errs["grad_ws"] = rel_err(grads["grad_ws"], ref_g["grad_ws"])
    errs["grad_noise"] = max(rel_err(grads[k], ref_g[k]) for k in ref_g if k != "grad_ws")
    weight_errs = sorted(((rel_err(gp[k], ref_gp[k]), k) for k in ref_gp), reverse=True)
    errs["grad_weights"] = weight_errs[0][0]
    log(f"tiny synthesis: {len(weight_errs)} weight gradients, the worst "
        + ", ".join(f"{k} {e:.2e}" for e, k in weight_errs[:4]))
    log("tiny synthesis card vs CPU, error relative to max |ref|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {TOL_SYNTH})")
    for k, v in errs.items():
        check(math.isfinite(v) and v <= TOL_SYNTH, f"tiny synthesis {k} disagrees: {v:.3e}")
    card, cpu = runs[(dev, "bfloat16")], runs[("cpu", "bfloat16")]
    check(set(card[2]) == set(ref_gp) == set(cpu[2]), "bf16 runs give gradients to other weights")
    check_bf16("tiny synthesis outputs", card[0], cpu[0], ref_out, rms_bound=RMS_BF16)
    check_bf16("tiny synthesis w and noise gradients", card[1], cpu[1], ref_g)
    check_bf16("tiny synthesis weight gradients", card[2], cpu[2], ref_gp)


def tiny_rotbbox_step(device, dtype="float32"):
    """One tiny_test_config RotBbox step on `device` in compute dtype
    `dtype` with all four regularizers (the camera yawed by 0.4, so the
    mirror term counts), the same seeded weights and the same injected
    draws on any device. Returns (the step's LPIPS, {weight: gradient on
    the CPU}, launches)."""
    import torch

    from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.models.rendering.renderer import draw_randoms
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.tools.workloads import synthetic_face
    from spi_tpu_torch.training import coaches
    from spi_tpu_torch.utils import camera as cam
    from spi_tpu_torch.utils.params import trainable_parameters

    cfg = tiny_test_config(compute_dtype=dtype)
    g = TriPlaneGenerator(cfg, device=device, seed=0)
    with torch.no_grad():  # nonzero noise strengths, so they get a gradient
        for name, t in g.named_parameters():
            if name.endswith("noise_strength"):
                t.fill_(0.1)
    lpips = LPIPS(device=device, cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
    box_cx = BoxCXLoss(device=device)
    gen = torch.Generator().manual_seed(5)
    m = cfg.neural_rendering_resolution ** 2

    def views(shape):  # a camera sampler's (u_yaw, u_pitch) and four views' renderer draws
        return {"cameras": (torch.rand(shape, generator=gen), torch.rand(shape, generator=gen)),
                "render": draw_randoms(cfg.rendering, 4, m, generator=gen)}

    draws = [{"recon": draw_randoms(cfg.rendering, 1, m, generator=gen),
              "rot": views((4,)), "mirror": views((4,)), "depth": views((4, 1)),
              "tv": {"uniform": torch.rand(1, 1000, 3, generator=gen),
                     "perturb": torch.randn(1, 1000, 3, generator=gen),
                     "directions": torch.randn(1, 2000, 3, generator=gen)}}]
    target = torch.tanh(torch.randn(1, 3, 128, 128, generator=gen))
    w = torch.randn(1, g.num_ws, g.w_dim, generator=gen) * 0.5
    mask, lm = synthetic_face("cpu", 128)
    settings = coaches.CoachSettings(num_steps=1, lpips_threshold=-1.0, tv_lambda=0.1)
    out = {}

    def on_step(step, lp):  # after the update, before the gradients are cleared
        out["lpips"] = lp
        out["grads"] = {k: p.grad.detach().cpu() for k, p in trainable_parameters(g).items()
                        if p.grad is not None}

    before = dict(_lib.launch_counts)
    coaches.tune_generator(
        g, lpips, coaches.CoachInputs(target, cam.canonical_camera(yaw=0.4), w, mask, lm / 2),
        settings, draws=draws, device=device, on_step=on_step, box_cx=box_cx)
    launched = {k: _lib.launch_counts[k] - before[k] for k in before}
    return out["lpips"], out["grads"], launched


def phase_tiny_rotbbox(dev):
    """Card (kernels) vs CPU (plain versions): one tiny RotBbox step's LPIPS
    and the gradient of every weight, to TOL_SYNTH of each one's largest
    entry; then in bfloat16, the gradients by check_bf16 and the LPIPS's
    error against the CPU's float32 within BF16_FACTOR times the CPU's
    bf16 error (+ 1e-3 of it), with bias_act launched in bf16."""
    ref_lp, ref_g, cpu_launched = tiny_rotbbox_step("cpu")
    lp, grads, launched = tiny_rotbbox_step(dev)
    check(not any(cpu_launched.values()), f"CPU run launched kernels: {cpu_launched}")
    check(all(launched[k] for k in INVERSION_KERNELS), f"card run skipped a kernel: {launched}")
    check(set(grads) == set(ref_g), "the card and the CPU give gradients to other weights")
    errs = sorted(((rel_err(grads[k], ref_g[k]), k) for k in ref_g), reverse=True)
    lp_err = abs(lp - ref_lp) / abs(ref_lp)
    worst = ", ".join(f"{k} {e:.2e}" for e, k in errs[:4])
    log(f"tiny RotBbox step card vs CPU: LPIPS {lp:.6f} vs {ref_lp:.6f} (rel {lp_err:.2e}); "
        f"{len(errs)} weight gradients, the worst {worst} (tol {TOL_SYNTH}); launches {launched}")
    check(lp_err <= TOL_SYNTH, f"tiny RotBbox LPIPS disagrees: {lp_err:.3e}")
    check(all(math.isfinite(e) and e <= TOL_SYNTH for e, _ in errs),
          f"tiny RotBbox gradient {errs[0][1]} disagrees: {errs[0][0]:.3e}")
    cpu_lp, cpu_g, cpu_launched = tiny_rotbbox_step("cpu", "bfloat16")
    lp, grads, launched = tiny_rotbbox_step(dev, "bfloat16")
    check(not any(cpu_launched.values()), f"CPU bf16 run launched kernels: {cpu_launched}")
    check(all(launched[k] for k in BF16_KERNELS), f"card bf16 run skipped a kernel: {launched}")
    check(set(grads) == set(ref_g) == set(cpu_g), "bf16 runs give gradients to other weights")
    e_card, e_cpu = abs(lp - ref_lp) / abs(ref_lp), abs(cpu_lp - ref_lp) / abs(ref_lp)
    log(f"tiny RotBbox step bf16: LPIPS card {lp:.6f}, CPU {cpu_lp:.6f}, CPU float32 "
        f"{ref_lp:.6f} (errors {e_card:.2e} / {e_cpu:.2e}); launches {launched}")
    check(e_card <= BF16_FACTOR * e_cpu + 1e-3, f"tiny RotBbox bf16 LPIPS error {e_card:.3e}")
    check_bf16("tiny RotBbox weight gradients", grads, cpu_g, ref_g)


def tiny_zssgan_step(device, draws=None):
    """One ZSSGAN step (tiny_test_config twins with noise strengths 0.1,
    tiny_test_clip, batch 2, the stand-in tokenizer) on `device`, from the
    same seeded weights. draws: the step's draws (z, each render's noise
    maps and renderer draws), else drawn on the CPU from a generator
    seeded 7. Returns (loss, {trained leaf: value after the step}, {trained
    leaf: gradient}, {leaf: value before}, {leaf: value after}, launches,
    draws), all on the CPU."""
    import torch

    from spi_tpu_torch.cli.run_editing import CRCTokenizer
    from spi_tpu_torch.editing import DirectionalCLIPLoss, EditingSettings, ZSSGANTrainer
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.models.perception.clip import CLIP, tiny_test_clip
    from spi_tpu_torch.ops import _lib

    g = TriPlaneGenerator(tiny_test_config(), device=device, seed=0)
    with torch.no_grad():
        for name, t in g.named_parameters():
            if name.endswith("noise_strength"):
                t.fill_(0.1)
    loss = DirectionalCLIPLoss(CLIP(tiny_test_clip(), device=device, seed=1))
    tr = ZSSGANTrainer(g, {"tiny": loss}, {"tiny": 1.0}, EditingSettings(batch=2), device=device)
    tr.build_states(CRCTokenizer(tiny_test_clip().vocab_size))
    if draws is None:
        draws = tr.draw(2, torch.Generator().manual_seed(7))
    before = {k: v.detach().cpu().clone() for k, v in tr.trainable.state_dict().items()}
    counts = dict(_lib.launch_counts)
    value = float(tr.step(draws))
    launched = {k: _lib.launch_counts[k] - counts[k] for k in counts}
    after = {k: v.detach().cpu() for k, v in tr.trainable.state_dict().items()}
    trained = {k: p for k, p in tr.trainable.named_parameters() if k in tr.mask}
    check(all(torch.equal(v.cpu(), before[k]) for k, v in tr.frozen.state_dict().items()),
          f"{device}: the frozen twin moved")
    return (value, {k: after[k] for k in trained}, {k: p.grad.cpu() for k, p in trained.items()},
            before, after, launched, draws)


def phase_tiny_zssgan(dev):
    """Card (kernels) vs CPU (plain versions): one tiny ZSSGAN step with
    random noise on the same draws: the loss and every trained leaf's
    gradient to TOL_SYNTH of its largest entry; on each side every trained
    leaf moved by Adam's first step of its own gradient, lr g / (|g| +
    eps), to TOL_SYNTH of lr, and every other leaf bitwise unchanged. The
    leaves are not compared across the two sides: dividing by |g| + eps
    turns a gradient element near eps = 1e-8, far below TOL_SYNTH of its
    leaf's largest gradient, into an update that may differ by up to a
    quarter of that element's own relative error (3.0e-3 of lr on one bias
    in a run on an H100); the cross-device leaf error is logged."""
    from spi_tpu_torch.editing import EditingSettings

    adam = EditingSettings().adam
    ref_loss, ref_leaves, ref_grads, before, after, cpu_launched, draws = tiny_zssgan_step("cpu")
    loss, leaves, grads, card_before, card_after, launched, _ = tiny_zssgan_step(dev, draws)
    check(not any(cpu_launched.values()), f"CPU run launched kernels: {cpu_launched}")
    check(all(launched[k] for k in INVERSION_KERNELS), f"card run skipped a kernel: {launched}")
    check(set(grads) == set(ref_grads), "the card and the CPU train other leaves")
    for side, b, a, g in (("CPU", before, after, ref_grads), ("card", card_before, card_after,
                                                               grads)):
        frozen_moved = [k for k in b if k not in g and not bool((a[k] == b[k]).all())]
        check(not frozen_moved, f"{side}: a leaf outside the mask moved: {frozen_moved[:4]}")
        step_err = max(float((a[k] - (b[k] - adam["lr"] * g[k] / (g[k].abs() + adam["eps"])))
                             .abs().max()) / adam["lr"] for k in g)
        log(f"tiny ZSSGAN {side}: the trained leaves moved by Adam's first step to "
            f"{step_err:.2e} of lr")
        check(step_err <= TOL_SYNTH, f"tiny ZSSGAN {side}: the update is not Adam's first step")
    errs = sorted(((rel_err(grads[k], ref_grads[k]), k) for k in ref_grads), reverse=True)
    leaf_errs = sorted(((rel_err(leaves[k], ref_leaves[k]), k) for k in ref_leaves),
                       reverse=True)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    log(f"tiny ZSSGAN step card vs CPU: loss {loss:.6f} vs {ref_loss:.6f} (rel {loss_err:.2e}); "
        f"{len(ref_grads)} trained leaves' gradients, the worst " + ", ".join(
            f"{k} {e:.2e}" for e, k in errs[:4]) + f" (tol {TOL_SYNTH}); the leaves after the "
        f"step, the worst {leaf_errs[0][1]} {leaf_errs[0][0]:.2e}; launches {launched}")
    check(loss_err <= TOL_SYNTH, f"tiny ZSSGAN loss disagrees: {loss_err:.3e}")
    check(all(math.isfinite(e) and e <= TOL_SYNTH for e, _ in errs),
          f"tiny ZSSGAN gradient of {errs[0][1]} disagrees: {errs[0][0]:.3e}")


def drive(label, kernels, fn):
    """Run `fn(on_step)` (a workload of spi_tpu_torch/tools/workloads.py)
    with every launch count at 0 just before it; the counts are read after
    each step. Fails unless each of `kernels` was launched. Returns (fn's
    result, launch counts, each step's launches (step 0's with the
    set-up's))."""
    import torch

    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.ops import plane_splat as ps

    counts = []
    copies = dict(ps.contiguous_copies)
    _lib.reset_launch_counts()
    result = fn(lambda step, value: counts.append(dict(_lib.launch_counts)))
    torch.cuda.synchronize()
    launches = dict(_lib.launch_counts)
    log(f"{label}: strided inputs the lookup copied: "
        f"{ {k: v - copies[k] for k, v in ps.contiguous_copies.items()} }")
    steps = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in launches}
             for i, c in enumerate(counts)]
    log(f"{label}: {len(counts)} steps; launches {launches}; in the last step {steps[-1]}")
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was never launched on the {label} path")
    return result, launches, steps


def device_kernels(prof):
    """{kernel name: (device ms, launches)} of a torch.profiler run: the
    events on the card with device time, less user annotations and the
    profiler's own step markers. Raises where there is none."""
    import torch

    per_kernel = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if (t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.key and not evt.key.startswith("ProfilerStep")):
            per_kernel[evt.key] = (t / 1e3, evt.count)
    if not per_kernel:
        raise RuntimeError("the profiler saw no device time")
    return per_kernel


def check_no_depthwise(label, fn, wait):
    """Run the workload `fn(on_step)` under torch.profiler and keep its step
    number `wait` + 1 (after `wait` steps and one warm-up step); fail where
    ATen's depthwise convolution ran in it: every generator FIR is the
    upfirdn2d kernel."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=wait, warmup=1, active=1)) as prof:
        fn(lambda step, value: prof.step())
    depthwise = [n for name, (_, n) in device_kernels(prof).items() if "conv_depthwise2d" in name]
    check(not depthwise, f"{label}: ATen's depthwise convolution ran ({sum(depthwise)} launches)")


def build_model(dev, dtype="float32"):
    """The workloads' model: ffhq512_128_config at its published widths and
    compute dtype `dtype`, random seeded weights; LPIPS-VGG16; a random
    512^2 target; the canonical camera."""
    import torch

    from spi_tpu_torch.tools import workloads

    t0 = time.perf_counter()
    model = workloads.build_model(dev, dtype)
    torch.cuda.synchronize()
    log(f"ffhq512_128 {dtype}: {sum(p.numel() for p in model[0].parameters())} generator "
        f"parameters, built in {time.perf_counter() - t0:.1f} s")
    return model


def check_projection(g, label, w, noise, dists):
    import torch

    log(f"{label}: dists {dists.tolist()}")
    check(tuple(w.shape) == (1, g.num_ws, g.w_dim) and bool(torch.isfinite(w).all()),
          f"{label}: w is not finite or has the wrong shape")
    check(bool(torch.isfinite(dists).all()), f"{label}: a projection loss is not finite")
    check(all(bool(torch.isfinite(v).all()) for v in noise.values()),
          f"{label}: noise is not finite")


def phase_project(dev, model, dtype="float32"):
    """Stage-1 'sg' projection at full FFHQ-512 width, in compute dtype
    `dtype` (`model`'s); then the third of three more 'sg' steps under
    torch.profiler, which must run no ATen depthwise convolution. Returns
    (w, noise) and the launch counts of the run."""
    from spi_tpu_torch.tools.workloads import PIVOT_STEPS, projection

    label = "sg project" + tag(dtype)
    (w, noise, dists), launches, steps = drive(
        label, PATH_KERNELS[dtype], projection(model, "sg", PIVOT_STEPS, dev))
    check_projection(model[0], label, w, noise, dists)
    check_lookups(label, steps[-1], dtype, 2)
    check_no_depthwise(f"'sg'{tag(dtype)} step", projection(model, "sg", 3, dev, seed=9), 1)
    return (w, noise), launches


def phase_mir(dev, model, num_steps=4, dtype="float32"):
    """Stage-1 'mir' projection at full width from a yawed camera, so that
    the mirror term's weight is nonzero. Both cameras render from one set
    of planes, so each render pass's splat serves both in one launch."""
    from spi_tpu_torch.tools.workloads import MIR_YAW, projection
    from spi_tpu_torch.utils import camera as cam

    camera = cam.canonical_camera(yaw=MIR_YAW, device=dev)
    weight = float(cam.cal_camera_weight(cam.mirror_camera(camera))[0])
    log(f"mir project: yaw {MIR_YAW}, mirror weight {weight:.5f}")
    check(weight > 0, "the mirror term has no weight at this camera")
    label = "mir project" + tag(dtype)
    (w, noise, dists), _, steps = drive(
        label, PATH_KERNELS[dtype], projection(model, "mir", num_steps, dev))
    per_step = steps[-1]
    check_projection(model[0], label, w, noise, dists)
    check(per_step["plane_splat"] == 2,
          f"mir: {per_step['plane_splat']} splat launches a step, not one per render pass")
    check_lookups(label, per_step, dtype, 2)


def phase_tune(dev, model, pivot, num_steps=6, dtype="float32"):
    """Stage-2 recon-only tuning at full width from phase 4's w and noise;
    the threshold is below any LPIPS value, so random weights do not stop
    it early."""
    import torch

    from spi_tpu_torch.tools.workloads import tuning
    from spi_tpu_torch.utils.params import trainable_parameters

    g = model[0]
    before = {k: p.detach().clone() for k, p in trainable_parameters(g).items()}
    label = "stage-2 tune" + tag(dtype)
    (_, (steps, last_lpips)), _, step_launches = drive(
        label, PATH_KERNELS[dtype], tuning(model, pivot, num_steps, dev))
    per_step = step_launches[-1]
    after = trainable_parameters(g)
    finite = all(bool(torch.isfinite(p).all()) for p in after.values())
    moved = sum(not torch.equal(before[k], p) for k, p in after.items())
    log(f"{label}: {steps} steps, last LPIPS {last_lpips:.6f}; weights finite {finite}, "
        f"{moved} of {len(after)} weight tensors moved")
    check(steps == num_steps and math.isfinite(last_lpips), "stage 2 stopped early or diverged")
    check(finite and moved > 0, "the tuned weights are not finite or did not move")
    check_lookups(label, per_step, dtype, 2)


def phase_rotbbox(dev, model, pivot, num_steps=9, dtype="float32"):
    """SPI's RotBbox stage 2 at full width from phase 4's w and noise
    (workloads.rotbbox: rot 0.1, mirror-rot 0.05, depth 1 from the camera
    yawed by MIR_YAW, synthetic face mask and landmarks). Steps 0, 4 and 8
    carry the regularizers. A regularizer step's backward splats 8 passes
    (recon, rot, mirror and the tuned depth render, coarse and fine), a
    reconstruction step's 2; the lookup runs in 10 passes and 2 (the
    original generator's depth render, two passes under no_grad, has no
    backward). Then one regularizer step under torch.profiler, which must
    run no ATen depthwise convolution."""
    import torch

    from spi_tpu_torch.tools.workloads import MIR_YAW, rotbbox
    from spi_tpu_torch.utils import camera as cam
    from spi_tpu_torch.utils.params import trainable_parameters

    weight = float(cam.cal_camera_weight(cam.canonical_camera(yaw=MIR_YAW, device=dev))[0])
    check(weight > 0, "the mirror-rot term has no weight at this camera")
    g = model[0]
    before = {k: p.detach().clone() for k, p in trainable_parameters(g).items()}
    label = "rotbbox tune" + tag(dtype)
    (_, (steps, last_lpips)), _, step_launches = drive(
        label, PATH_KERNELS[dtype], rotbbox(model, pivot, num_steps, dev))
    after = trainable_parameters(g)
    finite = all(bool(torch.isfinite(p).all()) for p in after.values())
    moved = sum(not torch.equal(before[k], p) for k, p in after.items())
    del before
    reg = [k for k in range(2, num_steps) if k % 4 == 0]
    rec = [k for k in range(2, num_steps) if k % 4]
    log(f"{label}: {steps} steps, last LPIPS {last_lpips:.6f}; mirror weight "
        f"{weight:.5f}; weights finite {finite}, {moved} of {len(after)} weight tensors moved")
    log(f"{label}: launches in regularizer step {reg[0]} {step_launches[reg[0]]}, in "
        f"reconstruction step {rec[0]} {step_launches[rec[0]]}")
    check(steps == num_steps and math.isfinite(last_lpips), "RotBbox stopped early or diverged")
    check(finite and moved > 0, "the tuned weights are not finite or did not move")
    for k in reg:
        check(step_launches[k]["plane_splat"] == 8,
              f"rotbbox step {k}: {step_launches[k]['plane_splat']} splat launches, not 8")
        check_lookups(f"rotbbox step {k}", step_launches[k], dtype, 10)
    for k in rec:
        check(step_launches[k]["plane_splat"] == 2,
              f"rotbbox step {k}: {step_launches[k]['plane_splat']} splat launches, not 2")
        check_lookups(f"rotbbox step {k}", step_launches[k], dtype, 2)
    check_no_depthwise(f"RotBbox{tag(dtype)} regularizer step", rotbbox(model, pivot, 5, dev), 3)


def write_identity(root, name, seed=0, yaw=None):
    """One synthetic 512^2 identity in the dataset's layout (tools/
    make_smoke_data.py's: crop/, c/, mask/, lm/), seen from the camera
    yawed by `yaw` (MIR_YAW by default): a soft blob of skin tones with
    noise from `seed`, the ellipse face mask as parsing id 1, landmarks on
    its ellipse at 256 scale."""
    import numpy as np
    import torch
    from PIL import Image

    from spi_tpu_torch.tools.workloads import MIR_YAW, synthetic_face
    from spi_tpu_torch.utils import camera as cam

    for sub in ("crop", "c", "mask", "lm"):
        (root / sub / name).mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:512, 0:512] / 511.0
    blob = np.exp(-(((xx - 0.5) ** 2) + (yy - 0.45) ** 2) / 0.05)
    img = np.stack([0.6 + 0.3 * blob, 0.45 + 0.25 * blob, 0.4 + 0.2 * blob], -1)
    img = img + np.random.default_rng(seed).normal(0, 0.01, img.shape)
    Image.fromarray((img.clip(0, 1) * 255).astype(np.uint8)).save(root / "crop" / name /
                                                                  "target.png")
    camera = cam.canonical_camera(yaw=MIR_YAW if yaw is None else yaw).numpy().reshape(25)
    np.save(root / "c" / name / "target.npy", camera)
    mask, lm = synthetic_face(torch.device("cpu"))
    np.save(root / "mask" / name / "target.npy", mask[0, 0].numpy().astype(np.int64))
    np.save(root / "lm" / name / "target.npy", lm[0].numpy())


def phase_cli(dev, dtype, first_steps=3, tune_steps=5):
    """`python -m spi_tpu_torch.cli.run_inversion` in this process at full
    width (random seeded weights, 'mir' stage 1, RotBbox stage 2 with rot
    0.1, mirror-rot 0.05, depth 1) in compute dtype `dtype` (bfloat16: the
    CLI's default, without --fp32) on one synthetic identity under
    build/cli_smoke: the results, the output tree, the npz keys and
    metric_log.txt, with the dtype's kernels launched; then a second run
    that reads the first one's embedding and tunes nothing, whose w is the
    cached pivot."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np

    from spi_tpu_torch.cli import run_inversion
    from spi_tpu_torch.ops import _lib

    root = Path(__file__).resolve().parent / "build" / f"cli_smoke_{dtype}"
    shutil.rmtree(root, ignore_errors=True)
    write_identity(root / "data", "synth0")
    out = root / "out"
    argv = ["--data_root", str(root / "data"), "--output_root", str(out), "--device", str(dev),
            "--random_init", *(["--fp32"] if dtype == "float32" else []),
            "--first_inv_type", "mir", "--first_inv_steps", str(first_steps),
            "--G_1_type", "RotBbox", "--G_1_step", str(tune_steps), "--pt_rot_lambda", "0.1",
            "--pt_mirror_rot_lambda", "0.05", "--pt_depth_lambda", "1",
            "--LPIPS_value_threshold", "-1"]
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = run_inversion.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    r = results[0]
    label = "cli" + tag(dtype)
    log(f"{label}: {wall:.1f} s for one identity (stage 1 {r['stage1_s']:.2f} s, stage 2 "
        f"{r['stage2_s']:.2f} s, {r['steps_run']} tuning steps); metrics {r['metrics']}; "
        f"launches {launches}")
    for k in PATH_KERNELS[dtype]:
        check(launches[k] > 0, f"kernel {k} was never launched on the {label} path")
    check(len(results) == 1 and r["steps_run"] == tune_steps, f"cli results {results}")
    check(all(math.isfinite(v) for v in r["metrics"].values()), f"cli metrics {r['metrics']}")
    (coach,) = os.listdir(out / "checkpoints")
    for sub, name in (("checkpoints", "synth0.npz"), ("embedding", "synth0.npz"),
                      ("image", "synth0.jpg"), ("image_m", "synth0.jpg")):
        check((out / sub / coach / name).exists(), f"cli wrote no {sub}/{coach}/{name}")
    with np.load(out / "checkpoints" / coach / "synth0.npz") as ck:
        n_g = sum(k.startswith("G.") for k in ck.files)
        check({"w", "c"} <= set(ck.files) and n_g > 0, "the checkpoint lacks w, c or G")
    lines = (out / "experiments" / "metric_log.txt").read_text().splitlines()
    check(lines[0] == f"Coach name: {coach}" and "Mode: G1_inv AVG" in lines,
          f"metric_log.txt: {lines[:8]}")
    with np.load(out / "embedding" / coach / "synth0.npz") as emb:
        cached = emb["w"]
    t0 = time.perf_counter()
    again = run_inversion.main(argv + ["--load_embedding_coach_name", coach, "--G_1_step", "0"])
    check(np.array_equal(np.asarray(again[0]["w"]), cached),
          "the second run did not reuse the cached pivot")
    log(f"{label}: {coach}: checkpoint with {n_g} G.* arrays, images, embedding and metric log "
        f"written; the second run reused the embedding in {time.perf_counter() - t0:.1f} s")


def profiled_device_ms(fn):
    """Device time (ms, summed over its kernels by torch.profiler) and
    kernel launches of one call of `fn`. For a network of hundreds of
    launches, whose enqueueing fills the launch queue that timing.device_ms
    would hide behind its sleep."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per_kernel = device_kernels(prof)
    return sum(t for t, _ in per_kernel.values()), sum(n for _, n in per_kernel.values())


def phase_preprocess(dev):
    """The three preprocess networks at full width (FAN with 4 hourglass
    modules at 256^2, the ResNet-50 at 224^2 with nonzero random heads,
    BiSeNet at 512^2), seeded random weights, float32: on the card against
    the same module on the CPU within TOL_SYNTH of the largest entry (the
    parsing map equal wherever the top two logits lie more than that
    apart), and each forward timed on the card: back-to-back, and its
    device time and launches under the profiler. Then `cli/run_preprocess.py
    --random_init --mirror` on one synthetic 640^2 photo: it fails on any
    failure `run_total` reports, and on a file of the tree missing or of
    the wrong shape. Returns the tree's root."""
    import shutil
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image

    from spi_tpu_torch.cli import run_preprocess
    from spi_tpu_torch.models.perception.bisenet import BiSeNet, parse_logits
    from spi_tpu_torch.models.perception.face_recon import FaceReconNet
    from spi_tpu_torch.models.perception.fan import FAN
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.preprocess.pipeline import PreprocessModels, run_total
    from spi_tpu_torch.tools.workloads import write_photo

    def recon_with_heads(device):
        net = FaceReconNet(device=device, seed=1)
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            for head in net.final_layers.values():
                head.weight.copy_(torch.randn(head.weight.shape, generator=gen) * 1e-3)
                head.bias.copy_(torch.randn(head.bias.shape, generator=gen) * 0.1)
        return net

    nets = {"FAN (4 modules)": (lambda d: FAN(device=d, seed=0), 256, lambda n, x: n(x)),
            "ResNet-50 3DMM": (recon_with_heads, 224, lambda n, x: n(x)),
            "BiSeNet": (lambda d: BiSeNet(device=d, seed=2), 512, parse_logits)}
    for label, (make, size, run) in nets.items():
        x = torch.rand(1, 3, size, size, generator=torch.Generator().manual_seed(size))
        xd = x.to(dev)
        with torch.no_grad():
            card_net = make(dev)
            got = run(card_net, xd)
            want = run(make("cpu"), x)
            ms = time_ms(lambda: run(card_net, xd))
            dms, launches = profiled_device_ms(lambda: run(card_net, xd))
        err = rel_err(got.cpu(), want)
        log(f"{label} at {size}^2: card vs CPU {err:.2e} of the largest entry; forward "
            f"{ms:.3f} ms on the card back-to-back, {dms:.3f} ms of device time in "
            f"{launches} kernel launches (profiled)")
        check(bool(torch.isfinite(got).all()) and err <= TOL_SYNTH, f"{label} disagrees: {err:.3e}")
        if label == "BiSeNet":
            top2 = want.topk(2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > TOL_SYNTH * float(want.abs().max())
            same = got.argmax(1).cpu() == want.argmax(1)
            check(bool(same[clear].all()), "BiSeNet's parsing map differs where the logits are clear")
        del card_net, got

    root = Path(__file__).resolve().parent / "build" / "preprocess_smoke"
    shutil.rmtree(root, ignore_errors=True)
    (root / "raw").mkdir(parents=True)
    write_photo(root / "raw" / "face0.png")
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    done, failures = run_preprocess.main(["--input_dir", str(root / "raw"), "--output_dir",
                                          str(root / "data"), "--random_init", "--mirror",
                                          "--device", str(dev)])
    wall = time.perf_counter() - t0
    log(f"run_preprocess: {done} done, failures {failures}, {wall:.2f} s with the models' build; "
        f"launches {dict((k, v) for k, v in _lib.launch_counts.items() if v)}")
    check(done == ["face0"] and not failures, f"run_preprocess failed: {failures}")
    data = root / "data"
    for sub in ("crop/face0/target.jpg", "crop/face0/target_m.jpg"):
        check(Image.open(data / sub).size == (512, 512), f"preprocess wrote no 512^2 {sub}")
    for sub, shape in (("c/face0/target.npy", (25,)), ("c/face0/target_m.npy", (25,)),
                       ("lm/face0/target.npy", (68, 2)), ("mask/face0/target.npy", (512, 512))):
        a = np.load(data / sub)
        check(a.shape == shape and bool(np.isfinite(a).all()), f"preprocess {sub}: {a.shape}")
    check(int(np.load(data / "mask/face0/target.npy").max()) < 19, "parsing ids of 19 or more")
    models = PreprocessModels.random_init(dev)
    run_total(str(root / "raw"), str(root / "again"), models, mirror=True, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, failures = run_total(str(root / "raw"), str(root / "again"), models, mirror=True,
                            verbose=False)
    log(f"run_total, one 640^2 photo with the models built and warm: "
        f"{time.perf_counter() - t0:.3f} s; failures {failures}")
    check(not failures, f"run_total failed: {failures}")
    return data


def phase_user_path(dev, data, first_steps=3, tune_steps=5):
    """The user's path on phase 11's tree in bfloat16 (the CLI's default):
    `cli/run_inversion.py --save_video` (SPI's RotBbox weights), then
    `cli/run_video.py --frames 8 --shape ... --shape_resolution 128` on the
    checkpoint it wrote. Checks the video files, the frames (8 of 512^2,
    the orbit's float images finite) and the mesh; counts the kernels'
    launches of each run, of one orbit chunk of 4 frames and of one
    density-probe chunk (each net of the planes' pass)."""
    import os

    import numpy as np
    import torch

    from spi_tpu_torch.cli import run_inversion, run_video
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.shape import sample_density_grid
    from spi_tpu_torch.utils.video import render_orbit_images

    out = data.parent / "out"
    argv = ["--data_root", str(data), "--data_mode", "jpg", "--output_root", str(out),
            "--device", str(dev), "--random_init", "--save_video",
            "--first_inv_type", "mir", "--first_inv_steps", str(first_steps),
            "--G_1_type", "RotBbox", "--G_1_step", str(tune_steps), "--pt_rot_lambda", "0.1",
            "--pt_mirror_rot_lambda", "0.05", "--pt_depth_lambda", "1",
            "--LPIPS_value_threshold", "-1"]
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    (r,) = run_inversion.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    log(f"cli --save_video on the preprocessed tree: {wall:.1f} s (stage 1 {r['stage1_s']:.2f}, "
        f"stage 2 {r['stage2_s']:.2f}); video {r['video']}; launches {launches}")
    for k in BF16_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the cli --save_video path")
    check(r["steps_run"] == tune_steps and all(math.isfinite(v) for v in r["metrics"].values()),
          f"cli results {r}")
    check(os.path.exists(r["video"]) and os.path.getsize(r["video"]) > 0, "no orbit video")

    (coach,) = os.listdir(out / "checkpoints")
    ckpt = out / "checkpoints" / coach / "face0.npz"
    ply = out / "face0.ply"
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_video.main(["--checkpoint", str(ckpt), "--output", str(out / "face0.mp4"),
                          "--frames", "8", "--shape", str(ply), "--shape_resolution", "128",
                          "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    log(f"run_video: {wall:.2f} s in all; 8 frames rendered in {res['render_s']:.3f} s "
        f"({8 / res['render_s']:.2f} frames/s) -> {res['video']}; shape 128^3: density probes "
        f"{res['probe_s']:.3f} s, marching tetrahedra and PLY {res['mesh_s']:.3f} s, "
        f"{len(res['verts'])} vertices, {len(res['faces'])} faces; launches {launches}")
    for k in ("bias_act_fwd", "bias_act_fwd_bf16", "plane_sample_bf16"):
        check(launches[k] > 0, f"kernel {k} was never launched by run_video")
    check(res["frames"].shape == (8, 512, 512, 3) and os.path.exists(res["video"]),
          f"run_video frames {res['frames'].shape}, video {res['video']}")
    check(len(res["verts"]) > 0 and len(res["faces"]) > 0 and ply.stat().st_size > 0,
          "the shape export wrote an empty mesh")

    # One chunk's and one probe chunk's launches, net of the planes' pass,
    # and the orbit's float images.
    g = TriPlaneGenerator(ffhq512_128_config(compute_dtype="bfloat16"), device=dev)
    flat = load_npz(str(ckpt))
    load_flat_params(g, {k[2:]: v for k, v in flat.items() if k.startswith("G.")})
    w = torch.from_numpy(flat["w"]).to(dev)
    counts = {}
    with torch.no_grad():
        for label, fn in (("planes", lambda: g.planes_nhwc(w)),
                          ("orbit chunk", lambda: render_orbit_images(g, w, num_frames=4)),
                          ("probe chunk", lambda: sample_density_grid(g, w, resolution=40))):
            _lib.reset_launch_counts()
            out_t = fn()
            torch.cuda.synchronize()
            counts[label] = {k: v for k, v in _lib.launch_counts.items() if v}
            if label == "orbit chunk":
                check(out_t.shape == (4, 3, 512, 512) and bool(torch.isfinite(out_t).all()),
                      "the orbit's images are not finite 512^2 frames")
    for label, what in (("orbit chunk", "4 frames"), ("probe chunk", "64,000 points")):
        net = {k: v - counts["planes"].get(k, 0) for k, v in counts[label].items()}
        log(f"launches of one {label} ({what}), net of the planes' pass "
            f"{counts['planes']}: {net}")
        check(net.get("plane_sample_bf16", 0) > 0, f"one {label} launched no bf16 lookup")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_orbit_images(g, w, num_frames=16)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"orbit, 16 frames with the generator warm: {warm:.3f} s ({16 / warm:.2f} frames/s)")
    return res


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



VMAP_B = 3  # images in phase 2's vmapped kernel calls


def phase_vmap_kernels(dev):
    """Phase 2 under torch.func.vmap (`utils/params.vmap_strict`), B =
    VMAP_B images: the splat on B coarse passes (each image its own
    planes and points) and both bias_act kernels (each image its own bias:
    the batched-bias form; and a shared one, folded into the rows), in
    float32 and bfloat16. Each against its plain version under the same
    vmap (the splat: the autograd of the plain 4-corner gather; bias_act:
    `bias_act_plain` under autograd) and against a loop over the images of
    the unbatched kernel; one launch of each kernel for the whole batch.
    Tolerances are phase 2's: the splat TOL_SPLAT; bias_act's y and dx
    bitwise against the loop (one kernel's arithmetic per element), within
    TOL_ELEMWISE (f32) or bitwise (bf16, lrelu and linear) against the
    plain chain; db, a sum in another order, within 1e-5 (f32) or 2^-8
    (bf16) of its largest entry."""
    import importlib

    import torch

    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.ops.grid_sample import sample_flat
    from spi_tpu_torch.tools.splat_tiles import coarse_pass_points
    from spi_tpu_torch.tools.timing import device_ms
    from spi_tpu_torch.utils.params import vmap_strict

    ba = importlib.import_module("spi_tpu_torch.ops.bias_act")
    b = VMAP_B
    gen = torch.Generator(device=dev).manual_seed(21)
    h = w = 256
    c = 32
    coarse = coarse_pass_points(dev)  # (1, P, 3): the canonical camera's coarse pass
    p = coarse.shape[1]
    geom = ps.RayGeom(1, 128, 128, 48)
    coords = torch.stack([coarse * (1.0 - 0.02 * i) for i in range(b)])  # (B, 1, P, 3)
    planes = torch.randn(b, 1, 3, h * w, c, device=dev, generator=gen).requires_grad_(True)
    cot = torch.randn(b, 1, 3, p, c, device=dev, generator=gen)

    def plain_sample(pl, x):
        n, _, hw, ch = pl.shape
        grids = ps.project_onto_planes(x * 2.0).reshape(n * 3, x.shape[1], 2)
        return sample_flat(pl.reshape(n * 3, hw, ch), grids, h, w).reshape(n, 3, -1, ch)

    copies = dict(ps.contiguous_copies)
    _lib.reset_launch_counts()
    out = vmap_strict(lambda pl, x: ps.sample_planes(pl, x, 1.0, geom))(planes, coords)
    (grad,) = torch.autograd.grad(out, planes, cot)
    torch.cuda.synchronize()
    launches = dict(_lib.launch_counts)
    check(launches["plane_splat"] == 1, f"vmapped splat: {launches['plane_splat']} launches")
    out_p = vmap_strict(plain_sample)(planes, coords)
    (grad_p,) = torch.autograd.grad(out_p, planes, cot)
    errs = {"plain": rel_err(grad, grad_p)}
    loop = torch.stack([ps.splat_cuda(coords[i].contiguous(), cot[i].contiguous(), 1.0, h, w,
                                      geom) for i in range(b)])
    errs["loop"] = rel_err(grad, loop)
    log(f"vmap splat, {b} coarse passes (1, 3, {p}, {c}) each: one launch; gradient against "
        f"the plain gather's autograd {errs['plain']:.3e}, against a loop of the kernel "
        f"{errs['loop']:.3e} (tol {TOL_SPLAT})")
    check(max(errs.values()) <= TOL_SPLAT, f"vmapped splat disagrees: {errs}")
    # The lookup in the same call, and in bfloat16 planes: one launch for
    # the batch, bitwise equal to a loop of unbatched kernel calls and to
    # the plain gather under the same vmap.
    forward = {"float32": (out.detach(), out_p.detach(), launches["plane_sample"])}
    del out, out_p, grad_p, loop
    pb = planes.detach().bfloat16()
    _lib.reset_launch_counts()
    out_b = vmap_strict(lambda pl, x: ps.sample_planes(pl, x, 1.0, geom))(pb, coords)
    torch.cuda.synchronize()
    forward["bfloat16"] = (out_b, vmap_strict(plain_sample)(pb, coords),
                           _lib.launch_counts["plane_sample_bf16"])
    for dtype, (got, plain, n_launch) in forward.items():
        src = planes.detach() if dtype == "float32" else pb
        loop = torch.stack([ps.sample_planes_cuda(src[i], coords[i].contiguous(), 1.0)
                            for i in range(b)])
        equal = (torch.equal(got, loop), torch.equal(got, plain))
        log(f"vmap lookup {dtype}, {b} coarse passes: {n_launch} launch(es); bitwise equal to a "
            f"loop of the kernel {equal[0]}, to the plain gather under vmap {equal[1]}")
        check(n_launch == 1 and all(equal), f"vmapped lookup {dtype} disagrees or relaunched")
        del loop, src
    check(ps.contiguous_copies == copies,
          f"the vmapped lookup copied strided inputs: {ps.contiguous_copies} (was {copies})")
    del grad, planes, cot, coords, forward, out_b, pb

    spec = ba.activation_funcs["lrelu"]
    clamp = 256.0 * spec.def_gain
    shapes = {"block128": ((1, 128, 128, 128), 1), "decoder": ((128 * 128 * 4, 64), 1)}
    for dtype in (torch.float32, torch.bfloat16):
        names = ba._COUNTS[dtype]
        for label, (shape, dim) in shapes.items():
            for batched_bias in (True, False):
                x = (torch.randn(b, *shape, device=dev, generator=gen) * 3).to(dtype)
                x.requires_grad_(True)
                bias = torch.randn(*((b,) if batched_bias else ()), shape[dim], device=dev,
                                   generator=gen).to(dtype).requires_grad_(True)
                g = torch.randn(b, *shape, device=dev, generator=gen).to(dtype)
                in_dims = (0, 0 if batched_bias else None)

                def kernel(xi, bi):
                    return ba.bias_act(xi, bi, dim=dim, act="lrelu", clamp=clamp)

                def plain(xi, bi):
                    return ba.bias_act_plain(xi, bi, dim=dim, act="lrelu", clamp=clamp)

                _lib.reset_launch_counts()
                y = vmap_strict(kernel, in_dims)(x, bias)
                dx, db = torch.autograd.grad(y, (x, bias), g)
                torch.cuda.synchronize()
                n_launch = (_lib.launch_counts[names[0]], _lib.launch_counts[names[1]])
                check(n_launch == (1, 1), f"vmapped bias_act {label}: launches {n_launch}")
                if dtype == torch.float32:  # the plain chain under autograd
                    yp = vmap_strict(plain, in_dims)(x, bias)
                    dxp, dbp = torch.autograd.grad(yp, (x, bias), g)
                else:  # bias_act_plain and the backward kernel's plain version
                    yp = vmap_strict(plain, in_dims)(x.detach(), bias.detach())
                    dxp = vmap_strict(lambda gi, xi, bi: ba.bias_act_grad_plain(
                        gi, xi, bi, dim=dim, act="lrelu", clamp=clamp), (0, 0, in_dims[1]))(
                        g, x.detach(), bias.detach())
                    dbp = _bias_sums(dxp, shape, dim, batched_bias).to(dtype)
                db_loop = torch.zeros(bias.shape, device=dev)  # float32 sums, one rounding
                same = True
                for i in range(b):
                    bi = bias[i] if batched_bias else bias
                    yi = ba.bias_act_fwd_cuda(x[i].detach(), bi.detach(), dim, spec.cuda_id,
                                              spec.def_alpha, spec.def_gain, clamp)
                    dxi = ba.bias_act_bwd_cuda(g[i], x[i].detach(), bi.detach(), dim,
                                               spec.cuda_id, spec.def_alpha, spec.def_gain,
                                               clamp)
                    same &= torch.equal(yi, y[i]) and torch.equal(dxi, dx[i])
                    dbi = _bias_sums(dxi[None], shape, dim, False)
                    if batched_bias:
                        db_loop[i] = dbi
                    else:
                        db_loop += dbi
                db_loop = db_loop.to(dtype)
                if dtype == torch.float32:
                    elem = max(float(((a - r).abs() - TOL_ELEMWISE * (1 + r.abs())).max())
                               for a, r in ((y, yp), (dx, dxp)))
                    plain_ok, db_tol = elem <= 0, 1e-5
                else:
                    plain_ok, db_tol = torch.equal(y, yp) and torch.equal(dx, dxp), 2.0 ** -8
                e_db = (rel_err(db.float(), dbp.float()), rel_err(db.float(), db_loop.float()))
                log(f"vmap bias_act {str(dtype)[6:]} {label} x {b} images, "
                    f"{'batched' if batched_bias else 'shared'} bias: launches {n_launch}; "
                    f"y, dx against the loop bitwise {same}, against the plain chain "
                    f"{'within tolerance' if plain_ok else 'OUT'}; db error {e_db[0]:.2e} "
                    f"(plain) / {e_db[1]:.2e} (loop) (tol {db_tol:.1e})")
                if batched_bias and label == "block128":
                    # The batched-bias form beside the unbatched one on the same B images.
                    xs, gs, bs = x.detach(), g, bias.detach()
                    cfg = (dim + 1, spec.cuda_id, spec.def_alpha, spec.def_gain, clamp)
                    t = [device_ms(fn) for fn in (
                        lambda: ba.bias_act_fwd_cuda(xs, bs, *cfg),
                        lambda: ba.bias_act_fwd_cuda(xs, bs[0], *cfg),
                        lambda: ba.bias_act_bwd_cuda(gs, xs, bs, *cfg),
                        lambda: ba.bias_act_bwd_cuda(gs, xs, bs[0], *cfg))]
                    log(f"bias_act {str(dtype)[6:]} {label} x {b} images, device-only: batched-bias "
                        f"form fwd {t[0]:.4f} ms, bwd {t[2]:.4f} ms; one bias for all fwd "
                        f"{t[1]:.4f} ms, bwd {t[3]:.4f} ms")
                check(same, f"vmapped bias_act {dtype} {label} differs from a loop of the kernel")
                check(plain_ok, f"vmapped bias_act {dtype} {label} disagrees with the plain chain")
                check(max(e_db) <= db_tol, f"vmapped bias_act {dtype} {label} db: {e_db}")
                del x, bias, g, y, dx, db, yp, dxp, dbp


def _bias_sums(dx, shape, dim, per_image):
    """bias_act's db from (B, *shape) dx: one (C,) sum over all B images, or
    (B, C) per image; in float32."""
    c = shape[dim]
    rows = dx.float().reshape(dx.shape[0], -1, c, math.prod(shape[dim + 1:]))
    return rows.sum(dim=(1, 3)) if per_image else rows.sum(dim=(0, 1, 3))


def phase_batched_vs_serial(dev, b=2, first_steps=2, tune_steps=5):
    """B images at full width in float32 through the batched program
    (`parallel.spmd_invert`) and one by one through `project` and
    `tune_generator`, with the same per-image generators ('mir' stage 1
    from the yawed camera, then RotBbox with rot 0.1, mirror-rot 0.05
    (BoxCX), depth 1, synthetic face mask and landmarks): w, the last
    LPIPS, the steps run and one tuned leaf per image within TOL_SYNTH of
    the largest entry. Then a threshold that one image reaches early (read
    from the first run's LPIPS): its steps run are fewer, and it equals
    the serial run's with that threshold. The first image's target is
    random, the second a smooth synthetic face, so that their LPIPS lie
    apart and one threshold stops one of them only."""
    import dataclasses

    import torch

    from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.parallel import spmd_invert
    from spi_tpu_torch.tools import workloads
    from spi_tpu_torch.training import coaches, projectors
    from spi_tpu_torch.utils.params import index_tree, trainable_parameters

    model = build_model(dev)
    g, lpips = model[0], model[1]
    targets, cameras = workloads.batch_inputs(model, b, dev, workloads.MIR_YAW)
    res = g.cfg.img_resolution
    yy, xx = torch.meshgrid(*(torch.linspace(0, 1, res, device=dev),) * 2, indexing="ij")
    blob = torch.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.05)
    targets[1] = torch.stack([0.6 + 0.3 * blob, 0.45 + 0.25 * blob, 0.4 + 0.2 * blob])[None] \
        * 2 - 1
    mask, lm = workloads.synthetic_face(dev, res)
    masks, lms = mask[None].expand(b, *mask.shape), lm[None].expand(b, *lm.shape)
    box = BoxCXLoss(device=dev)
    proj = projectors.ProjectorSettings(mode="mir", num_steps=first_steps, w_avg_samples=600)
    free = coaches.CoachSettings(num_steps=tune_steps, lpips_threshold=-1.0, rot_lambda=0.1,
                                 mirror_rot_lambda=0.05, depth_lambda=1.0)
    start = {k: v.detach().clone() for k, v in trainable_parameters(g).items()}
    leaf = "superresolution.block1.conv1.weight"

    def rngs():
        return [torch.Generator(device=dev).manual_seed(31 + i) for i in range(b)]

    def batched(settings, trace=None):
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = spmd_invert(g, lpips, proj, settings, box_cx=box, device=dev)(
            targets, cameras, rngs=rngs(), face_masks=masks, landmarks=lms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in INVERSION_KERNELS:
            check(_lib.launch_counts[k] > 0, f"kernel {k} was never launched on the batched path")
        check(all(torch.equal(v, start[k]) for k, v in trainable_parameters(g).items()),
              "the batched path changed the generator module's weights")
        return out, wall, dict(_lib.launch_counts)

    def serial(settings, i):
        rng = rngs()[i]
        t0 = time.perf_counter()
        w, noise, _ = projectors.project(g, lpips, targets[i], cameras[i], proj, rng=rng,
                                         device=dev)
        lps = []
        _, (steps, lp) = coaches.tune_generator(
            g, lpips, coaches.CoachInputs(targets[i], cameras[i], w, masks[i], lms[i]),
            settings, noise=noise, rng=rng, device=dev, box_cx=box,
            on_step=lambda step, v: lps.append(v))
        torch.cuda.synchronize()
        tuned = trainable_parameters(g)[leaf].detach().clone()
        with torch.no_grad():
            for k, v in trainable_parameters(g).items():
                v.copy_(start[k])
        return w, steps, lp, tuned, lps, time.perf_counter() - t0

    def compare(label, out, i, ser):
        w_b, _, tuned_b, steps_b, lps_b, _ = out
        w, steps, lp, tuned, _, _ = ser
        errs = (rel_err(w_b[i], w), abs(lps_b[i] - lp) / abs(lp), rel_err(tuned_b[leaf][i], tuned))
        log(f"{label} image {i}: steps {steps_b[i]} / {steps}, last LPIPS {lps_b[i]:.6f} / "
            f"{lp:.6f}; errors relative to the largest entry: w {errs[0]:.2e}, LPIPS "
            f"{errs[1]:.2e}, {leaf} {errs[2]:.2e} (tol {TOL_SYNTH})")
        check(steps_b[i] == steps and max(errs) <= TOL_SYNTH,
              f"{label} image {i} differs from the serial path: {errs}")

    out, wall, launches = batched(free)
    sers = [serial(free, i) for i in range(b)]
    log(f"batched float32, {b} images ({first_steps} 'mir' + {tune_steps} RotBbox): {wall:.2f} s "
        f"against {sum(r[-1] for r in sers):.2f} s one by one; launches {launches}")
    for i in range(b):
        compare("batched vs serial", out, i, sers[i])
    # A threshold lane `a` crosses at step k >= 1 and the other lanes never.
    lps = [r[4] for r in sers]
    found = [(k, a) for a in range(b) for k in range(1, tune_steps - 1)
             if lps[a][k] < min(lps[a][:k])
             and all(lps[a][k] < min(lps[o]) for o in range(b) if o != a)]
    check(found, f"no threshold that one image reaches early: LPIPS {lps}")
    k, a = found[0]
    # Halfway between that value and the lowest that must stay above it, so
    # that rounding apart from the serial run does not move the stop.
    above = min([*lps[a][:k], *(v for o in range(b) if o != a for v in lps[o])])
    settings = dataclasses.replace(free, lpips_threshold=(lps[a][k] + above) / 2)
    out, wall, _ = batched(settings)
    steps_b = out[3]
    log(f"threshold {settings.lpips_threshold:.6f}: steps run {steps_b} (image {a} stops at "
        f"step {k})")
    check(steps_b[a] == k + 1 and all(steps_b[o] == tune_steps for o in range(b) if o != a),
          f"early stop: steps {steps_b}")
    compare("early-stopped image", out, a, serial(settings, a))
    del out, sers, model, g, lpips, box
    torch.cuda.empty_cache()


def phase_batch_launches(dev, steps=5):
    """Launches a step at B = 1, 2, 4 through the batched path, float32 and
    bfloat16: 'sg' (the last step) and a RotBbox cadence of 4 steps (steps
    1-4, the fourth a regularizer step, summed), which must equal B = 1's.
    A cell that does not fit the card's memory is reported as such. Then a
    B = 4 'sg' step in each dtype and a bf16 B = 4 RotBbox regularizer step
    under torch.profiler, which must run no ATen depthwise convolution."""
    import torch

    from spi_tpu_torch.tools import workloads

    table = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(dev, dtype)
        pivot = None
        for b in (1, 2, 4):
            label = f"batched 'sg' B={b}{tag(dtype)}"
            (w, noise, _), _, per_step = drive(
                label, PATH_KERNELS[dtype], workloads.projection_batch(model, "sg", steps, dev, b))
            table[(dtype, "sg", b)] = per_step[-1]
            if pivot is None:
                pivot = (w[0], {k: v[0] for k, v in noise.items()})
            label = f"batched RotBbox B={b}{tag(dtype)}"
            try:
                _, _, per_step = drive(
                    label, PATH_KERNELS[dtype], workloads.rotbbox_batch(model, pivot, steps, dev, b))
            except torch.cuda.OutOfMemoryError as e:
                log(f"{label}: out of device memory ({str(e).splitlines()[0][:160]})")
                table[(dtype, "rotbbox", b)] = None
                torch.cuda.empty_cache()
                continue
            cadence = {k: sum(s[k] for s in per_step[1:5]) for k in per_step[1]}
            fir = "upfirdn2d" + ("_bf16" if dtype == "bfloat16" else "")
            log(f"{label}: {cadence[fir]} {fir} launches in one RotBbox cadence (steps 1-4), "
                f"{per_step[4][fir]} in its regularizer step")
            table[(dtype, "rotbbox", b)] = cadence
            torch.cuda.empty_cache()
        for path in ("sg", "rotbbox"):
            one = table[(dtype, path, 1)]
            for b in (2, 4):
                cell = table[(dtype, path, b)]
                if cell is not None:
                    check(cell == one, f"{path}{tag(dtype)} B={b}: launches {cell} "
                          f"differ from B=1's {one}")
        check_no_depthwise(f"batched 'sg'{tag(dtype)} step, B=4",
                           workloads.projection_batch(model, "sg", 3, dev, 4), 1)
        if dtype == "bfloat16" and table[(dtype, "rotbbox", 4)] is not None:
            check_no_depthwise(f"batched RotBbox{tag(dtype)} regularizer step, B=4",
                               workloads.rotbbox_batch(model, pivot, 5, dev, 4), 3)
        del model, pivot
        torch.cuda.empty_cache()


def phase_cli_batched(dev, n=4, first_steps=3, tune_steps=5):
    """The inversion CLI with --parallel_images 4 on four synthetic
    identities (each its own yaw and noise) in bfloat16 (3 'mir' + 5
    RotBbox steps): every image's results, checkpoint, embedding and
    images, and the bf16 kernels launched."""
    import os
    import shutil
    from pathlib import Path

    from spi_tpu_torch.cli import run_inversion
    from spi_tpu_torch.ops import _lib

    root = Path(__file__).resolve().parent / "build" / "cli_batched"
    shutil.rmtree(root, ignore_errors=True)
    names = [f"synth{i}" for i in range(n)]
    for i, name in enumerate(names):
        write_identity(root / "data", name, seed=i, yaw=(0.4, -0.3, 0.25, 0.1)[i % 4])
    out = root / "out"
    argv = ["--data_root", str(root / "data"), "--output_root", str(out), "--device", str(dev),
            "--random_init", "--parallel_images", str(n),
            "--first_inv_type", "mir", "--first_inv_steps", str(first_steps),
            "--G_1_type", "RotBbox", "--G_1_step", str(tune_steps), "--pt_rot_lambda", "0.1",
            "--pt_mirror_rot_lambda", "0.05", "--pt_depth_lambda", "1",
            "--LPIPS_value_threshold", "-1"]
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = run_inversion.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    log(f"cli --parallel_images {n} bf16: {wall:.1f} s for {n} identities "
        f"({results[0]['stage1_s']:.2f} s an image by the batch's clock); launches {launches}")
    for k in BF16_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the batched cli path")
    check([r["name"] for r in results] == names, f"cli results {[r['name'] for r in results]}")
    (coach,) = os.listdir(out / "checkpoints")
    for r in results:
        log(f"cli batched {r['name']}: steps {r['steps_run']}, metrics {r['metrics']}")
        check(r["steps_run"] == tune_steps and len(r["metrics"]) == 6
              and all(math.isfinite(v) for v in r["metrics"].values()), f"cli result {r}")
        for sub, ext in (("checkpoints", "npz"), ("embedding", "npz"), ("image", "jpg"),
                         ("image_m", "jpg")):
            check((out / sub / coach / f"{r['name']}.{ext}").exists(),
                  f"the batched cli wrote no {sub}/{coach}/{r['name']}.{ext}")
    lines = (out / "experiments" / "metric_log.txt").read_text()
    check(lines.count("ID: ") == n, "metric_log.txt does not list every image")


# Run by `phase_two_processes` as each rank: the inversion CLI, then this
# process's launch counts as JSON.
RANK_CODE = """
import json, sys
from spi_tpu_torch.cli import run_inversion
from spi_tpu_torch.ops import _lib
results = run_inversion.main(sys.argv[1:])
print("RANK_RESULT " + json.dumps({"names": [r["name"] for r in results],
                                   "launches": dict(_lib.launch_counts)}), flush=True)
"""


def phase_two_processes(dev, n=3):
    """`--dataset_block auto` in two processes on the one card (one rank
    each, gloo, the environment torchrun sets: MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK), the tiny generator in bfloat16 on three
    synthetic identities: the stripes (2 + 1 images), the global means that
    rank 0 prints and writes equal to the mean of every image's metrics,
    the bf16 kernels launched in each process, and both exit 0."""
    import ast
    import os
    import re
    import shutil
    import socket
    from pathlib import Path

    here = Path(__file__).resolve().parent
    root = here / "build" / "two_processes"
    shutil.rmtree(root, ignore_errors=True)
    for i in range(n):
        write_identity(root / "data", f"synth{i}", seed=10 + i, yaw=0.3)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--data_root", str(root / "data"), "--output_root", str(root / "out"),
            "--device", dev.type, "--tiny", "--random_init", "--dataset_block", "auto",
            "--first_inv_type", "mir", "--first_inv_steps", "2", "--G_1_type", "RotBbox",
            "--G_1_step", "2", "--pt_rot_lambda", "0.1", "--pt_mirror_rot_lambda", "0.05",
            "--pt_depth_lambda", "1", "--LPIPS_value_threshold", "-1"]
    t0 = time.perf_counter()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), PYTHONPATH=str(here),
                   GLOO_SOCKET_IFNAME="lo")  # gloo on the loopback interface
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_CODE, *argv], cwd=here,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            outs.append(out)
            check(proc.returncode == 0, f"a rank exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    wall = time.perf_counter() - t0
    per_image, ranks = {}, []
    for out in outs:
        for line in out.splitlines():
            m = re.match(r"(\S+): w .* metrics=(\{.*\})$", line)
            if m:
                per_image[m.group(1)] = ast.literal_eval(m.group(2))
            if line.startswith("RANK_RESULT "):
                ranks.append(json.loads(line[len("RANK_RESULT "):]))
    log(f"two processes, --dataset_block auto: {wall:.1f} s; stripes "
        f"{[r['names'] for r in ranks]}; launches {[r['launches'] for r in ranks]}")
    check([r["names"] for r in ranks] == [["synth0", "synth1"], ["synth2"]],
          f"stripes {[r['names'] for r in ranks]}")
    for r in ranks:
        for k in BF16_KERNELS:
            check(r["launches"][k] > 0, f"a rank never launched {k}")
    m = re.search(r"global metric means over all processes: (\{.*\})", outs[0])
    check(m is not None, "rank 0 printed no global means")
    means = ast.literal_eval(m.group(1))
    (logged,) = (root / "out" / "experiments" / "metric_log_global.txt").read_text().splitlines()
    check(ast.literal_eval(logged) == means, "metric_log_global.txt differs from the printed means")
    for k, v in means.items():
        want = sum(p[k] for p in per_image.values()) / len(per_image)
        check(abs(v - want) <= 1e-5 * max(abs(want), 1e-3),
              f"global mean {k} {v} is not the images' mean {want}")
    log(f"two processes: global means {means} over {sorted(per_image)}")


EDIT_CLIPS = (("ViT-B/32", "vit_b32"), ("ViT-B/16", "vit_b16"))


def phase_editing(dev, num_steps=6):
    """CLIP-guided editing at full width in float32, the CLI's defaults:
    twin ffhq512_128_config generators and ViT-B/32 + ViT-B/16 at their
    published widths (seeded random weights), batch 2, the direction term
    only, the stand-in tokenizer. `num_steps` steps with the launch counts
    from 0; only the masked leaves move, the frozen twin is bitwise
    unchanged, the losses are finite. One more step under torch.profiler
    runs no ATen depthwise convolution; one IDE3D step moves ToRGB."""
    import zlib

    import torch

    from spi_tpu_torch.cli.run_editing import CRCTokenizer
    from spi_tpu_torch.editing import (
        DirectionalCLIPLoss,
        EditingSettings,
        IDE3DZSSGANTrainer,
        ZSSGANTrainer,
    )
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.models.perception import clip as clip_models

    t0 = time.perf_counter()
    frozen = TriPlaneGenerator(ffhq512_128_config(), device=dev, seed=0)
    losses = {name: DirectionalCLIPLoss(clip_models.CLIP(
        getattr(clip_models, config_name)(), device=dev, seed=zlib.crc32(name.encode()) % 2**31))
        for name, config_name in EDIT_CLIPS}
    weights = {name: 1.0 for name in losses}
    trainer = ZSSGANTrainer(frozen, losses, weights, EditingSettings(), device=dev, seed=2)
    torch.cuda.synchronize()
    n_clip = sum(p.numel() for loss in losses.values() for p in loss.model.parameters())
    log(f"editing: twins and {n_clip} CLIP weights built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    states = trainer.build_states(CRCTokenizer(clip_models.vit_b32().vocab_size))
    torch.cuda.synchronize()
    log(f"editing: build_states {time.perf_counter() - t0:.3f} s for {len(states)} models "
        f"(32 text encodes of 79 prompts each a model)")
    frozen_before = {k: v.clone() for k, v in frozen.state_dict().items()}
    start = {k: v.clone() for k, v in trainer.trainable.state_dict().items()}

    def steps(n, on_step):
        values = []
        for i in range(n):
            values.append(trainer.step())
            on_step(i, values[-1])
        return [float(v) for v in values]

    values, launches, per_step = drive(
        "editing", INVERSION_KERNELS, lambda on_step: steps(num_steps, on_step))
    check(all(math.isfinite(v) for v in values), f"editing losses {values}")
    moved = {k for k, v in trainer.trainable.state_dict().items() if not torch.equal(v, start[k])}
    check(moved and moved <= trainer.mask, f"editing: leaves outside the mask moved: "
          f"{sorted(moved - trainer.mask)[:4]}")
    check(all(torch.equal(v, frozen_before[k]) for k, v in frozen.state_dict().items()),
          "editing: the frozen twin moved")
    log(f"editing: losses {values}; {len(moved)} of {len(trainer.mask)} masked leaves moved "
        f"(the rest are noise_const buffers); launches a step {per_step[-1]}")
    check_no_depthwise("editing step", lambda on_step: steps(3, on_step), 1)
    ide3d = IDE3DZSSGANTrainer(frozen, losses, weights, EditingSettings(), device=dev, seed=3)
    ide3d.states = states
    torgb = {k: v.clone() for k, v in ide3d.trainable.state_dict().items()
             if ".torgb." in k and k in ide3d.mask}
    value = float(ide3d.step())
    after = ide3d.trainable.state_dict()
    torgb_moved = [k for k, v in torgb.items() if not torch.equal(after[k], v)]
    log(f"editing --ide3d: loss {value:.6f}; {len(torgb_moved)} of {len(torgb)} ToRGB leaves moved")
    check(math.isfinite(value) and torgb_moved, "editing --ide3d: ToRGB did not move")


def phase_editing_clis(dev, iters=3, frames=8, size=1024):
    """cli/run_editing.py --random_init at full width (3 steps, samples at 0
    and 2): the sample grids, and a final.npz with every generator key that
    loads into the port's TriPlaneGenerator; then
    cli/generate_edit_videos.py at --size 1024 on two seeded random 2D
    StyleGAN2 checkpoints written here (four --ckpt, two each, the combined
    video's square grid), --unedited_frames 8: the videos or their
    fallbacks, and the bias_act forward kernel launched."""
    import shutil
    from pathlib import Path

    import numpy as np

    from spi_tpu_torch.cli import generate_edit_videos, run_editing
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.models.stylegan2 import Generator, seeded_init
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz, module_flat, save_flat

    root = Path(__file__).resolve().parent / "build" / "edit_smoke"
    shutil.rmtree(root, ignore_errors=True)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_editing.main(["--frozen_gen_ckpt", "unused", "--output_dir", str(root / "edit"),
                            "--random_init", "--iter", str(iters), "--output_interval", "2",
                            "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    log(f"run_editing: {wall:.1f} s ({res['states_s']:.2f} s text states, {res['steps_s']:.2f} s "
        f"for {iters} steps with samples); losses {res['losses']}; launches {launches}")
    for k in INVERSION_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched by run_editing")
    check([Path(p).name for p in res["samples"]] == ["dst_000000.jpg", "dst_000002.jpg"]
          and all(Path(p).exists() for p in res["samples"]), f"samples {res['samples']}")
    g = TriPlaneGenerator(ffhq512_128_config(), device=dev)
    flat = load_npz(res["checkpoint"])
    check(set(flat) == set(g.state_dict()), "final.npz lacks generator keys")
    load_flat_params(g, flat)
    del g, res

    ckpts = []
    for seed in (0, 1):
        gen = Generator(512, 0, 512, size, 3, channel_base=32768, channel_max=512, device=dev)
        seeded_init(gen, seed)
        ckpts.append(str(root / f"domain{seed}.npz"))
        save_flat(ckpts[-1], module_flat(gen))
    latent = str(root / "latent.npy")
    np.save(latent, np.random.default_rng(0).normal(size=(1, gen.num_ws, 512))
            .astype(np.float32))
    del gen
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = generate_edit_videos.main([
        "--ckpt", ckpts[0], ckpts[1], ckpts[1], ckpts[0], "--out_dir", str(root / "videos"),
        "--source_latent", latent, "--unedited_frames", str(frames), "--size", str(size),
        "--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    log(f"generate_edit_videos: {wall:.1f} s for 4 x {frames} frames and {frames} blended at "
        f"{size}^2; files {[str(Path(v).relative_to(root)) for v in res['videos']]}; "
        f"launches {launches}")
    check(launches["bias_act_fwd"] > 0, "generate_edit_videos launched no bias_act forward")
    check(all(Path(v).exists() for v in res["videos"]) and len(res["videos"]) == 6,
          f"videos {res['videos']}")
    check(len(res["blended"]) == frames and res["blended"][0].shape == (size, size, 3),
          "generate_edit_videos: blended frames")
    check(not np.array_equal(res["frames"][0][0], res["frames"][1][0]),
          "generate_edit_videos: two domains rendered alike")
    shutil.rmtree(root / "videos", ignore_errors=True)


def _double_backward(fn, x, b, w, v, u):
    """d/d(x, b) of sum(v * dL/dx) + sum(u * dL/db), L = sum(w * fn(x, b)^2)
    (the square makes the cotangent reaching fn's backward depend on x, as a
    layer's does inside a network, so that the backward kernel runs again
    as the backward of the backward)."""
    import torch

    x = x.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    gx, gb = torch.autograd.grad((fn(x, b).square() * w).sum(), (x, b), create_graph=True)
    outer = (gx * v).sum() + (gb * u).sum() + 0.0 * (x.sum() + b.sum())
    return torch.autograd.grad(outer, (x, b))


def phase_bias_act_grad2(dev):
    """Phase 2, bias_act's second order (float32): the second-order kernel
    against `bias_act_grad2_plain` at (1, 128, 256, 256) for every activation
    with and without clamp, the kink row at x + b = 0 included (elements
    within 4 ulp of the clamp left out and counted, as for the backward),
    within TOL_ELEMWISE; a double backward through `bias_act` on the card
    against the same on the CPU (the plain chain), within TOL_ELEMWISE, with
    the backward kernel launched as the backward of the backward and the
    second-order kernel exactly where act'' is not identically 0;
    `_BiasActCudaGrad` and the second-order Function under vmap (B =
    VMAP_B, a batched and a shared bias), one launch each, bitwise a loop of
    the kernels; and the kernel's times against its bound and the plain
    version."""
    import importlib

    import torch

    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.tools.timing import device_ms
    from spi_tpu_torch.utils.params import vmap_strict

    ba = importlib.import_module("spi_tpu_torch.ops.bias_act")
    shape, dim = (1, 128, 256, 256), 1
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(*shape, device=dev, generator=gen) * 3.0
    b = torch.randn(shape[dim], device=dev, generator=gen)
    x[KINK_ROW] = -b
    g, gg = (torch.randn(*shape, device=dev, generator=gen) for _ in range(2))
    worst = 0.0
    for act in sorted(ba.activation_funcs):
        spec = ba.activation_funcs[act]
        for clamp in (None, 2.5):
            cfg = (dim, spec.cuda_id, spec.def_alpha, 1.7, clamp)
            out = ba.bias_act_grad2_cuda(gg, g, x, b, *cfg)
            ref = ba.bias_act_grad2_plain(gg, g, x, b, dim=dim, act=act, gain=1.7, clamp=clamp)
            n_near = 0
            if clamp is not None:
                pre = ba.bias_act_plain(x, b, dim=dim, act=act, gain=1.7)
                near = (pre.abs() - clamp).abs() <= 1e-6
                n_near = int(near.sum())
                out, ref = out.masked_fill(near, 0), ref.masked_fill(near, 0)
                del pre, near
            check(n_near <= 1e-4 * x.numel(), f"{n_near} elements at the clamp for {act}")
            err = float((out - ref).abs().max())
            excess = float(((out - ref).abs() - TOL_ELEMWISE * (1 + ref.abs())).max())
            kink = float((out[KINK_ROW] - ref[KINK_ROW]).abs().max())
            worst = max(worst, err)
            log(f"bias_act_grad2 {act:8s} clamp {clamp}: max abs err {err:.2e}, at the kink "
                f"row {kink:.2e} ({n_near} elements at the clamp left out)")
            check(excess <= 0, f"bias_act_grad2 {act} clamp {clamp} disagrees: {err:.3e}")
    # A double backward through bias_act, card (kernels) against CPU (plain chain).
    cg = torch.Generator().manual_seed(6)
    small = (2, 16, 8, 8)
    for act in sorted(ba.activation_funcs):
        for clamp in (None, 2.5):
            xs = torch.randn(*small, generator=cg) * 2
            bs = torch.randn(16, generator=cg)
            xs[0, :, 0, 0] = -bs
            w, v = (torch.randn(*small, generator=cg) for _ in range(2))
            u = torch.randn(16, generator=cg)

            def fn(xi, bi):
                return ba.bias_act(xi, bi, act=act, gain=1.3, clamp=clamp)

            want = _double_backward(fn, xs, bs, w, v, u)
            _lib.reset_launch_counts()
            got = _double_backward(fn, *(t.to(dev) for t in (xs, bs, w, v, u)))
            torch.cuda.synchronize()
            n = dict(_lib.launch_counts)
            errs = [float(((a.cpu() - r).abs() - TOL_ELEMWISE * (1 + r.abs())).max())
                    for a, r in zip(got, want)]
            second = int(ba.activation_funcs[act].grad2 is not None)
            log(f"double backward {act:8s} clamp {clamp}: card vs CPU excess over tolerance "
                f"{max(errs):.2e}; launches fwd {n['bias_act_fwd']}, bwd {n['bias_act_bwd']}, "
                f"grad2 {n['bias_act_grad2']}")
            check(max(errs) <= 0, f"double backward through bias_act {act} disagrees")
            check((n["bias_act_fwd"], n["bias_act_bwd"], n["bias_act_grad2"]) == (1, 3, second),
                  f"double backward {act}: launches {n}")
    # Under vmap: one launch for the batch (each image (128, 64, 64), channels first).
    spec = ba.activation_funcs["softplus"]
    cfg = (0, spec.cuda_id, spec.def_alpha, 1.7, 2.5)
    vshape = (VMAP_B, 128, 64, 64)
    gv, xv, ggv = (torch.randn(*vshape, device=dev, generator=gen) for _ in range(3))
    for batched_bias in (True, False):
        bv = torch.randn(*((VMAP_B,) if batched_bias else ()), 128, device=dev, generator=gen)
        in_dims = (0, 0, 0 if batched_bias else None)
        _lib.reset_launch_counts()
        dx = vmap_strict(lambda gi, xi, bi: ba._BiasActCudaGrad.apply(gi, xi, bi, *cfg),
                         in_dims)(gv, xv, bv)
        ddx = vmap_strict(lambda a, gi, xi, bi: ba._BiasActCudaGrad2.apply(a, gi, xi, bi, *cfg),
                          (0,) + in_dims)(ggv, gv, xv, bv)
        torch.cuda.synchronize()
        n = (_lib.launch_counts["bias_act_bwd"], _lib.launch_counts["bias_act_grad2"])
        same = all(torch.equal(dx[i], ba.bias_act_bwd_cuda(gv[i], xv[i], bi, *cfg))
                   and torch.equal(ddx[i], ba.bias_act_grad2_cuda(ggv[i], gv[i], xv[i], bi, *cfg))
                   for i, bi in enumerate(bv if batched_bias else [bv] * VMAP_B))
        log(f"vmap _BiasActCudaGrad / second order, {VMAP_B} x {vshape[1:]}, "
            f"{'batched' if batched_bias else 'shared'} bias: launches {n}, bitwise a loop of "
            f"the kernels {same}")
        check(n == (1, 1) and same, f"vmapped second order: launches {n}, loop equal {same}")
    # Times: softplus (act'' nonzero) with a clamp, at the block's shape.
    spec = ba.activation_funcs["softplus"]
    cfg = (dim, spec.cuda_id, spec.def_alpha, 1.0, 256.0)

    def plain():
        return ba.bias_act_grad2_plain(gg, g, x, b, dim=dim, act="softplus", gain=1.0,
                                       clamp=256.0)

    ms = time_ms(lambda: ba.bias_act_grad2_cuda(gg, g, x, b, *cfg))
    plain_ms = time_ms(plain)
    dms = device_ms(lambda: ba.bias_act_grad2_cuda(gg, g, x, b, *cfg))
    plain_dms = device_ms(plain)
    n = x.numel()
    b_ms, b_by = bound_ms(4 * n * 4 + shape[dim] * 4, 12 * n)
    log(f"bias_act_grad2 softplus {shape}: {ms:.4f} ms (plain {plain_ms:.4f}, bound {b_ms:.4f} "
        f"by {b_by}); device-only {dms:.4f} (plain {plain_dms:.4f}) ms")
    return {"name": "bias_act_grad2", "route": "cuda", "source": "spi_tpu_torch/csrc/bias_act.cu",
            "replaces": "spi_tpu/ops/bias_act_pallas.py:96", "max_abs_err": worst, "ms": ms,
            "device_ms": dms, "plain_ms": plain_ms, "plain_device_ms": plain_dms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "library_device_ms": None}


GAN_KERNELS = ("plane_splat", "plane_sample_bf16", "bias_act_fwd", "bias_act_bwd",
               "bias_act_fwd_bf16", "bias_act_bwd_bf16")  # D in float32, G in bfloat16
TINY_GAN_P = 0.5


def tiny_gan_steps(device, draws=None):
    """Two steps of the tiny trainer of spi_tpu's GAN tests (float32, batch 2,
    r1_interval = density_reg_interval = 2: step 0 runs R1 and density TV,
    step 1 neither; the pipe at p = TINY_GAN_P; noise strengths 0.5) on
    `device`, from the same seeded weights and inputs. draws: both steps'
    draws, else drawn on the CPU from a generator seeded 8. Returns (step 0's
    R1 term, each step's metrics, step 0's {'g'|'d': {name: gradient}},
    each step's launches, draws), on the CPU."""
    import torch

    from spi_tpu_torch.models import TriPlaneGenerator
    from spi_tpu_torch.models.discriminator import DualDiscriminator
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.training.augment import AugmentPipe
    from spi_tpu_torch.training.gan import (
        TINY_DISCRIMINATOR,
        GANConfig,
        GANTrainer,
        tiny_gan_config,
    )
    from spi_tpu_torch.utils.camera import canonical_camera
    from spi_tpu_torch.utils.params import to_device

    g = TriPlaneGenerator(tiny_gan_config(), device=device, seed=0)
    with torch.no_grad():
        for name, t in g.named_parameters():
            if name.endswith("noise_strength"):
                t.fill_(0.5)
    d = DualDiscriminator(c_dim=25, **TINY_DISCRIMINATOR, device=device, seed=1)
    tr = GANTrainer(g, d, GANConfig(batch_per_device=2, r1_interval=2, density_reg_interval=2),
                    augment=AugmentPipe(), device=device)
    gen = torch.Generator().manual_seed(8)
    real = torch.tanh(torch.randn(2, 3, 128, 128, generator=gen)).to(device)
    z = torch.randn(2, 16, generator=gen).to(device)
    if draws is None:
        draws = [tr.draw(2, gen) for _ in range(2)]
    c = canonical_camera(batch_size=2, device=device)
    _, aux = tr.d_loss(real, z, c, to_device(draws[0]["d"], tr.device), 0, TINY_GAN_P)
    r1 = float(aux["r1"].detach())
    metrics, launched, grads = [], [], None
    for step in range(2):
        before = dict(_lib.launch_counts)
        m = tr.step(real, z, c, TINY_GAN_P, draws[step])
        metrics.append({k: float(v) for k, v in m.items()})
        launched.append({k: _lib.launch_counts[k] - before[k] for k in before})
        if step == 0:
            grads = {w: {k: p.grad.detach().cpu() for k, p in leaves.items()}
                     for w, leaves in (("g", tr.g_leaves), ("d", dict(d.named_parameters())))}
    return r1, metrics, grads, launched, draws


def phase_tiny_gan(dev):
    """Card (kernels) vs CPU (plain versions): one tiny GAN step with R1 and
    density TV on the same draws (each render's noise maps and renderer
    draws, the pipe's, density TV's): the R1 term, the D and G losses, rt,
    fake_score and every D and G gradient to TOL_SYNTH of the largest entry;
    R1 differentiates twice through the pipe (grid_sample's gathers), the
    antialiased resize, conv2d_resample and cuDNN and the bias_act kernels.
    The R1 step launches more bias_act backward kernels than the step
    without R1 that follows it."""
    ref_r1, ref_m, ref_g, cpu_launched, draws = tiny_gan_steps("cpu")
    r1, m, grads, launched, _ = tiny_gan_steps(dev, draws)
    check(not any(any(s.values()) for s in cpu_launched), "the CPU run launched kernels")
    check(all(launched[0][k] for k in INVERSION_KERNELS),
          f"card R1 step skipped a kernel: {launched[0]}")
    r1_err = abs(r1 - ref_r1) / abs(ref_r1)
    m_err = {k: abs(m[0][k] - ref_m[0][k]) / max(abs(ref_m[0][k]), 1e-6) for k in ref_m[0]}
    errs = sorted(((rel_err(grads[w][k], ref_g[w][k]), f"{w}:{k}") for w in ref_g
                   for k in ref_g[w]), reverse=True)
    log(f"tiny GAN step card vs CPU: R1 {r1:.6f} vs {ref_r1:.6f} (rel {r1_err:.2e}); metrics "
        + ", ".join(f"{k} {m[0][k]:.6f} ({e:.1e})" for k, e in m_err.items())
        + f"; {len(errs)} gradients, the worst " + ", ".join(f"{k} {e:.2e}" for e, k in errs[:4])
        + f" (tol {TOL_SYNTH}); step 1 losses card {m[1]['loss_d']:.6f} / "
        f"{m[1]['loss_g']:.6f}, CPU {ref_m[1]['loss_d']:.6f} / {ref_m[1]['loss_g']:.6f}")
    log(f"tiny GAN launches: R1 + TV step {launched[0]}; plain step {launched[1]}")
    check(r1 > 0 and r1_err <= TOL_SYNTH, f"tiny GAN R1 disagrees: {r1_err:.3e}")
    check(max(m_err.values()) <= TOL_SYNTH, f"tiny GAN metrics disagree: {m_err}")
    check(all(math.isfinite(e) and e <= TOL_SYNTH for e, _ in errs),
          f"tiny GAN gradient of {errs[0][1]} disagrees: {errs[0][0]:.3e}")
    check(launched[0]["bias_act_bwd"] > launched[1]["bias_act_bwd"],
          "the R1 step launched no more backward kernels than a plain step")


GAN_BATCH = 8  # run_gan_training's default --batch
GAN_P = 0.2


def gan_trainer(dev, batch):
    """ffhq512_128_config at nrr 64 in bfloat16 and DualDiscriminator(c_dim=25,
    img_resolution=512), seeded random, the ADA pipe; a synthetic batch of
    512^2 images at the canonical camera."""
    import torch

    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.models.discriminator import DualDiscriminator
    from spi_tpu_torch.training.augment import AugmentPipe
    from spi_tpu_torch.training.gan import GANConfig, GANTrainer
    from spi_tpu_torch.utils.camera import canonical_camera

    g = TriPlaneGenerator(ffhq512_128_config(neural_rendering_resolution=64,
                                             compute_dtype="bfloat16"), device=dev, seed=0)
    d = DualDiscriminator(c_dim=25, img_resolution=512, device=dev, seed=1)
    tr = GANTrainer(g, d, GANConfig(batch_per_device=batch), augment=AugmentPipe(), device=dev,
                    seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    real = torch.rand(batch, 3, 512, 512, device=dev, generator=gen) * 2 - 1
    c = canonical_camera(batch_size=batch, device=dev)
    return tr, real, c


def gan_steps(tr, real, c, counts):
    """One step at each of `counts` (the trainer's step number, which picks
    the regularizers), with its launches. Returns [(launches, metrics)]."""
    import torch

    from spi_tpu_torch.ops import _lib

    out = []
    for n in counts:
        tr.step_count = n
        z = torch.randn(real.shape[0], tr.generator.z_dim, device=real.device, generator=tr.rng)
        before = dict(_lib.launch_counts)
        m = tr.step(real, z, c, GAN_P)
        out.append(({k: _lib.launch_counts[k] - before[k] for k in before},
                    {k: float(v) for k, v in m.items()}))
    return out


class KernelInputs:
    """While entered, records the arguments of the largest call (by
    elements; the lookup's by points) of each kernel wrapper on the GAN
    path, as copies: the splat, the lookup (in its planes' dtype), the
    bias_act forward and backward in float32 and bfloat16, and the
    float32 backward launched as the backward of the backward (R1's second
    order, inside `_BiasActCudaGrad.backward`)."""

    def __enter__(self):
        import importlib

        import torch

        from spi_tpu_torch.ops import plane_splat as ps

        ba = importlib.import_module("spi_tpu_torch.ops.bias_act")

        self.calls = {}
        self.second_order = 0
        self.saved = [(ba, "bias_act_fwd_cuda", ba.bias_act_fwd_cuda),
                      (ba, "bias_act_bwd_cuda", ba.bias_act_bwd_cuda),
                      (ps, "splat_cuda", ps.splat_cuda),
                      (ps, "sample_planes_cuda", ps.sample_planes_cuda),
                      (ba._BiasActCudaGrad, "backward", ba._BiasActCudaGrad.__dict__["backward"])]
        self.originals = {name: fn for _, name, fn in self.saved}

        def recorder(name, fn, first):
            def call(*args):
                key = name
                if name != "plane_splat":  # the lookup's dtype is its planes'
                    dt = args[0].dtype if name == "plane_sample" else args[first].dtype
                    key += "" if dt == torch.float32 else "_bf16"
                    if name == "bias_act_bwd" and self.second_order:
                        key += " (R1 second order)"
                n = args[first].numel()
                if n > self.calls.get(key, (0, None))[0]:
                    self.calls[key] = (n, [a.detach().clone() if hasattr(a, "detach") else a
                                           for a in args])
                return fn(*args)
            return call

        backward = self.originals["backward"].__func__

        def tagged_backward(ctx, gg):
            self.second_order += 1
            try:
                return backward(ctx, gg)
            finally:
                self.second_order -= 1

        ba.bias_act_fwd_cuda = recorder("bias_act_fwd", ba.bias_act_fwd_cuda, 0)
        ba.bias_act_bwd_cuda = recorder("bias_act_bwd", ba.bias_act_bwd_cuda, 1)
        ps.splat_cuda = recorder("plane_splat", ps.splat_cuda, 1)
        ps.sample_planes_cuda = recorder("plane_sample", ps.sample_planes_cuda, 1)
        ba._BiasActCudaGrad.backward = staticmethod(tagged_backward)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)
        return False


def check_kernel_inputs(calls, originals, label):
    """Each recorded call (KernelInputs) again through its kernel, against
    its plain version on the same inputs: the splat within TOL_SPLAT of the
    largest entry; the lookup bitwise; bias_act in float32 within TOL_ELEMWISE (absolute +
    relative), in bfloat16 bitwise for linear and lrelu and within
    TOL_BF16_ULP for the others (TOL_SATURATED_DX for the saturating
    activations' dx), as phase 2 holds them. Where act(x + b) * gain lies
    within 1e-5 of the clamp, the two may clamp apart: such elements are
    left out of the comparison and counted. Returns {kernel: max abs err}."""
    import torch

    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.ops.bias_act import (
        activation_funcs,
        bias_act_grad_plain,
        bias_act_plain,
    )

    names = {spec.cuda_id: name for name, spec in activation_funcs.items()}
    worst = {}
    for key, (_, args) in sorted(calls.items()):
        if key == "plane_splat":
            coords, g, box_warp, h, w, geom = args[:6]
            got = originals["splat_cuda"](*args)
            want = ps.splat_plain(coords, g, box_warp, h, w)
            err = rel_err(got, want)
            worst[key] = float((got - want).abs().max())
            log(f"{label} kernel inputs: splat {tuple(g.shape)} ({coords.shape[0] * coords.shape[1]} "
                f"points), {geom}: max abs err {worst[key]:.3e}, rel {err:.3e} (tol {TOL_SPLAT})")
            check(err <= TOL_SPLAT, f"splat disagrees at the {label}'s shape {tuple(g.shape)}")
            continue
        if key.startswith("plane_sample"):
            planes, coords, box_warp = args
            got = originals["sample_planes_cuda"](*args)
            want = ps.sample_planes_plain(planes, coords, box_warp)
            worst[key] = float((got - want).abs().max())
            log(f"{label} kernel inputs: {key} {tuple(planes.shape)} {planes.dtype} at "
                f"{coords.shape[0] * coords.shape[1]} points: bitwise equal {torch.equal(got, want)}")
            check(torch.equal(got, want), f"{key} differs at the {label}'s shape {tuple(coords.shape)}")
            continue
        fwd = key.startswith("bias_act_fwd")
        g, (x, b, dim, act_id, alpha, gain, clamp) = (None, args) if fwd else (args[0], args[1:])
        act = names[act_id]
        kw = dict(dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)
        if fwd:
            got = originals["bias_act_fwd_cuda"](*args)
            want = bias_act_plain(x, b, **kw)
        else:
            got = originals["bias_act_bwd_cuda"](*args)
            want = bias_act_grad_plain(g, x, b, **kw)
        d = (got.float() - want.float()).abs()
        worst[key] = float(d.max())
        ok = torch.zeros_like(d, dtype=torch.bool)
        n_near = 0
        if clamp is not None:
            pre = bias_act_plain(x, b, **{**kw, "clamp": None}).float()
            near = (pre.abs() - clamp).abs() <= 1e-5 * clamp
            n_near = int(near.sum())
            ok |= near
            del pre, near
        if x.dtype == torch.float32:
            ok |= d <= TOL_ELEMWISE * (1 + want.abs())
            rule = f"TOL_ELEMWISE {TOL_ELEMWISE}"
        elif act in ("linear", "lrelu"):
            ok |= d == 0
            rule = "bitwise"
        else:
            ok |= d <= TOL_BF16_ULP * bf16_ulp(want.float())
            if not fwd and act in SATURATING:
                ok |= d <= TOL_SATURATED_DX * g.float().abs() * gain
            rule = f"{TOL_BF16_ULP} bf16 ulp"
        log(f"{label} kernel inputs: {key} {act} {tuple(x.shape)} {x.dtype}, gain {gain:.4f}, "
            f"clamp {clamp}: max abs err {worst[key]:.3e} ({rule}; {n_near} elements at the "
            f"clamp left out)")
        check(bool(ok.all()), f"{key} disagrees with its plain version at the {label}'s shape "
              f"{tuple(x.shape)}: {int((~ok).sum())} elements")
        check(n_near <= max(1e-4 * x.numel(), 1), f"{key}: {n_near} elements at the clamp")
        del got, want, d, ok
    return worst


def phase_gan(dev):
    """GAN training at full width (run_gan_training's model, its default batch
    of GAN_BATCH; if that does not fit the card, 4, EG3D's per-GPU batch): 6
    steps, step 0 with R1 and density TV (cold), step 4 with density TV, then
    one more R1 + TV step warm (step number 16); each step's launches;
    finite losses, every parameter of D and G that gets a gradient moved
    (the superresolution's noise strengths get none: its noise mode is
    'none'), G_ema moved less than G; last, each kernel at the largest
    shape an R1 + TV step gives it against its plain version
    (KernelInputs). Returns the kernels' launches in a plain step."""
    import torch

    from spi_tpu_torch.ops import _lib

    def run(batch):
        tr, real, c = gan_trainer(dev, batch)
        start = {w: {k: p.detach().clone() for k, p in mod.named_parameters()}
                 for w, mod in (("g", tr.generator), ("d", tr.discriminator))}
        _lib.reset_launch_counts()
        return tr, real, c, start, gan_steps(tr, real, c, [0, 1, 2, 3, 4, 5, 16])

    batch = GAN_BATCH
    try:
        tr, real, c, start, steps = run(batch)
    except torch.cuda.OutOfMemoryError as e:
        log(f"GAN batch {batch} does not fit the card ({str(e)[:200]}); running at batch 4")
        torch.cuda.empty_cache()
        batch = 4
        tr, real, c, start, steps = run(batch)
    launches = dict(_lib.launch_counts)
    for i, (n, m) in enumerate(steps):
        log(f"GAN batch {batch} step {i}: metrics {m}, launches "
            + ", ".join(f"{k} {v}" for k, v in n.items() if v))
        check(all(math.isfinite(v) for v in m.values()), f"GAN step {i}: a loss is not finite")
    for k in GAN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the GAN path")
    check(launches["bias_act_grad2"] == 0, "D's lrelu / linear launched the second-order kernel")
    check(steps[0][0]["bias_act_bwd"] > steps[1][0]["bias_act_bwd"],
          "the R1 step launched no more float32 backward kernels than a plain step")
    log(f"GAN launches a step: plain {steps[1][0]}; R1 + TV {steps[6][0]}; TV {steps[4][0]}")
    # Two renders a step (D's fakes under no_grad, G's), two passes each;
    # density TV samples two point sets more.
    for i, kind, n in ((1, "plain", 4), (4, "density TV", 6), (6, "R1 + density TV", 6)):
        check_lookups(f"GAN {kind} step", steps[i][0], "bfloat16", n)
    moved = {}
    for w, mod in (("g", tr.generator), ("d", tr.discriminator)):
        still = [k for k, p in mod.named_parameters() if torch.equal(p.detach(), start[w][k])]
        moved[w] = still
    check(not moved["d"], f"D parameters that did not move: {moved['d'][:4]}")
    check(all(k.startswith("superresolution.") and k.endswith("noise_strength")
              for k in moved["g"]), f"G parameters that did not move: {moved['g'][:4]}")
    d_g = sum(float((p.detach() - start["g"][k]).abs().sum())
              for k, p in tr.generator.named_parameters())
    d_ema = sum(float((p - start["g"][k]).abs().sum()) for k, p in tr.g_ema.named_parameters())
    log(f"GAN: G moved {d_g:.4e} (sum |delta|), G_ema {d_ema:.4e}; G parameters that got no "
        f"gradient and stayed: {moved['g']}")
    check(0 < d_ema < d_g, "G_ema did not move less than G")

    # The kernels at the shapes this path gives them, against their plain
    # versions: one more R1 + density TV step records each wrapper's
    # largest call.
    with KernelInputs() as rec:
        gan_steps(tr, real, c, [64])
    want = {"plane_splat", "plane_sample_bf16", "bias_act_fwd", "bias_act_bwd",
            "bias_act_bwd (R1 second order)", "bias_act_fwd_bf16", "bias_act_bwd_bf16"}
    check(want <= set(rec.calls), f"the GAN step made no call to {sorted(want - set(rec.calls))}")
    del tr
    torch.cuda.empty_cache()
    errs = check_kernel_inputs(rec.calls, rec.originals, "GAN")
    log("GAN kernel inputs, max abs err against the plain versions: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return steps[1][0]


def phase_gan_cli(dev, n_images=16):
    """cli/run_gan_training.py at full width on a synthetic folder of
    n_images 512^2 images with a dataset.json of canonical-camera labels,
    --max_steps 4 --tick_kimg 0.008 --snap 1 (a tick and a snapshot every
    step at batch 8): stats.jsonl, the snapshots, the kernels launched, and
    network-final.npz loaded into the port's TriPlaneGenerator renders a
    finite image; then the tiny trainer through the CLI in two processes on
    the one card (gloo, torchrun's environment): both exit 0, the
    replicas of G, D and G_ema agree bitwise after two steps."""
    import os
    import shutil
    import socket
    from pathlib import Path

    import numpy as np
    import torch
    from PIL import Image

    from spi_tpu_torch.cli import run_gan_training
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils.camera import canonical_camera
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz

    here = Path(__file__).resolve().parent
    root = here / "build" / "gan_cli"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    label = canonical_camera()[0].tolist()
    for i in range(n_images):
        Image.fromarray(rng.integers(0, 255, (512, 512, 3), np.uint8)).save(data / f"{i}.png")
    (data / "dataset.json").write_text(json.dumps(
        {"labels": [[f"{i}.png", label] for i in range(n_images)]}))
    out = root / "out"
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    tr = run_gan_training.main(["--data", str(data), "--outdir", str(out), "--max_steps", "4",
                                "--tick_kimg", "0.008", "--snap", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    files = sorted(os.listdir(out))
    lines = (out / "stats.jsonl").read_text().splitlines()
    log(f"GAN CLI: {tr.step_count} steps in {wall:.1f} s (model build included); files {files}; "
        f"{len(lines)} stats lines, the last {lines[-1][:200]}; launches {launches}")
    for k in GAN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched by the GAN CLI")
    check(files == ["network-000000.npz", "network-final.npz", "stats.jsonl"] and len(lines) == 4,
          f"GAN CLI wrote {files}, {len(lines)} stats lines")
    del tr
    torch.cuda.empty_cache()
    g = TriPlaneGenerator(ffhq512_128_config(), device=dev, seed=5)
    load_flat_params(g, load_npz(str(out / "network-final.npz")))
    with torch.no_grad():
        img = g.synthesis(g.mapping(torch.randn(1, 512, device=dev), canonical_camera(device=dev)),
                          canonical_camera(device=dev))["image"]
    check(tuple(img.shape) == (1, 3, 512, 512) and bool(torch.isfinite(img).all()),
          "the snapshot's generator renders no finite image")
    log("GAN CLI: network-final.npz loads into TriPlaneGenerator(ffhq512_128_config()) and "
        "renders a finite 512^2 image")
    del g, img
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--data", str(data), "--outdir", str(root / "tiny"), "--tiny", "--batch", "4",
            "--max_steps", "2", "--tick_kimg", "0.004", "--snap", "1", "--n_devices", "2"]
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   PYTHONPATH=str(here), GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_GAN_CODE, *argv], cwd=here,
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for proc in procs:
            o, err = proc.communicate(timeout=300)
            outs.append(o)
            check(proc.returncode == 0, f"a GAN rank exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    ranks = [json.loads(o.split("RANK_RESULT ")[-1]) for o in outs]
    equal = [line for line in outs[0].splitlines() if "bitwise equal" in line]
    log(f"GAN two processes: {time.perf_counter() - t0:.1f} s; {outs[0].splitlines()[0]}; "
        f"{equal}; launches {[r['launches'] for r in ranks]}")
    check("process group: gloo, 2 processes" in outs[0], "rank 0 did not report gloo")
    # main checks G, D and G_ema against rank 0's at every snapshot (it raises
    # where they differ) and leaves the process group at its end.
    check(len(equal) == 3, f"rank 0 reported {len(equal)} replica checks, not 3: {equal}")
    for r in ranks:
        check(r["steps"] == 2 and r["group_left"], f"a GAN rank: {r}")
        for k in BF16_KERNELS:
            check(r["launches"][k] > 0, f"a GAN rank never launched {k}")


# Run by `phase_gan_cli` as each rank: the GAN CLI, then the replica check of
# G, D and G_ema and this process's launch counts as JSON.
RANK_GAN_CODE = """
import json, sys
import torch.distributed as dist
from spi_tpu_torch.cli import run_gan_training
from spi_tpu_torch.ops import _lib
tr = run_gan_training.main(sys.argv[1:])
print("RANK_RESULT " + json.dumps({"steps": tr.step_count, "group_left": not dist.is_initialized(),
                                   "launches": dict(_lib.launch_counts)}), flush=True)
"""


# A tiny StyleGAN3-T (14 layers, 32², 16 channels at most), phase 3.
SG3_TINY = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3,
                channel_base=128, channel_max=16)
# StyleGAN3-T FFHQ-1024 at its published widths (stylegan3-t-ffhq-1024x1024.pkl;
# spi_tpu's SG3Generator defaults), phase 23.
SG3_T = dict(z_dim=512, c_dim=0, w_dim=512, img_resolution=1024, img_channels=3)
SG3_T_ENTRIES = 22_315_239  # parameters plus persistent buffers
SG3_KERNELS = ("bias_act_fwd", "bias_act_bwd", "filtered_lrelu_fwd", "filtered_lrelu_bwd",
               "filtered_lrelu_bias_grad")
# The kernels of the composition the fused filtered_lrelu replaced: no SG3-T
# layer launches them.
SG3_UNFUSED = ("upfirdn2d",)


def tiny_sg3(device):
    """The tiny SG3Generator's forward and backward on `device` (seeded
    weights and z, so the same on any device), truncation 0.7, with the
    launch counts set to 0 just before it. Returns (output, {'z' or
    parameter: gradient}, forward launches, backward launches), on the CPU."""
    import torch

    from spi_tpu_torch.models.stylegan3 import SG3Generator
    from spi_tpu_torch.ops import _lib

    g = SG3Generator(**SG3_TINY, device=device, seed=0)
    gen = torch.Generator().manual_seed(21)
    z = torch.randn(2, SG3_TINY["z_dim"], generator=gen).to(device).requires_grad_(True)
    r = torch.randn(2, 3, 32, 32, generator=gen).to(device)
    _lib.reset_launch_counts()
    y = g(z, None, truncation_psi=0.7)
    fwd = dict(_lib.launch_counts)
    (y * r).sum().backward()
    bwd = {k: v - fwd[k] for k, v in _lib.launch_counts.items()}
    grads = {"z": z.grad.cpu(), **{k: p.grad.cpu() for k, p in g.named_parameters()}}
    return y.detach().cpu(), grads, fwd, bwd


def phase_tiny_sg3(dev):
    """The tiny SG3 generator on the card (the fused filtered_lrelu kernels
    in every layer, one forward and one backward a layer and the bias
    gradient's, no upfirdn2d; bias_act in the affine and mapping layers)
    against the CPU (the composition's plain versions): the output and the
    gradients of z and every parameter to TOL_SYNTH of each one's largest
    entry."""
    out_cpu, g_cpu, fwd_cpu, bwd_cpu = tiny_sg3("cpu")
    out, grads, fwd, bwd = tiny_sg3(dev)
    check(not any(fwd_cpu.values()) and not any(bwd_cpu.values()), "the CPU run launched kernels")
    check(fwd["bias_act_fwd"] > 0 and bwd["bias_act_bwd"] > 0,
          f"the tiny SG3 skipped a kernel: forward {fwd}, backward {bwd}")
    layers = SG3_TINY.get("num_layers", 14) + 1
    check(fwd["filtered_lrelu_fwd"] == layers and bwd["filtered_lrelu_bwd"] == layers
          and bwd["filtered_lrelu_bias_grad"] == layers
          and not any(fwd[k] or bwd[k] for k in SG3_UNFUSED),
          f"the tiny SG3's {layers} layers did not each take the fused kernels: forward {fwd}, "
          f"backward {bwd}")
    check(set(grads) == set(g_cpu), "the card and the CPU give gradients to other weights")
    errs = sorted(((rel_err(grads[k], g_cpu[k]), k) for k in g_cpu), reverse=True)
    out_err = rel_err(out, out_cpu)
    log(f"tiny SG3: launches forward {fwd['filtered_lrelu_fwd']} filtered_lrelu_fwd, "
        f"{fwd['bias_act_fwd']} bias_act_fwd, backward {bwd['filtered_lrelu_bwd']} "
        f"filtered_lrelu_bwd, {bwd['filtered_lrelu_bias_grad']} filtered_lrelu_bias_grad, "
        f"{bwd['bias_act_bwd']} bias_act_bwd; card vs CPU, error relative to max |ref|: output "
        f"{out_err:.2e}, {len(errs)} gradients, the worst "
        + ", ".join(f"{k} {e:.2e}" for e, k in errs[:4]) + f" (tol {TOL_SYNTH})")
    check(math.isfinite(out_err) and out_err <= TOL_SYNTH, f"tiny SG3 output: {out_err:.3e}")
    check(all(math.isfinite(e) and e <= TOL_SYNTH for e, _ in errs),
          f"tiny SG3 gradient of {errs[0][1]} disagrees: {errs[0][0]:.3e}")


def persistence_meta(module, class_name, init_kwargs=None):
    """EG3D's persistence record of `module` (torch_utils/persistence.py:37):
    its raw __dict__ state on the CPU, the constant `resample_filter`
    buffers included as EG3D pickles them, each child a record of its own."""
    state = {
        "training": False,
        "_parameters": {k: v.detach().cpu().clone() for k, v in module._parameters.items()},
        "_buffers": {k: v.cpu().clone() for k, v in module._buffers.items()
                     if v is not None and (k not in module._non_persistent_buffers_set
                                           or k == "resample_filter")},
        "_modules": {k: persistence_meta(m, type(m).__name__) for k, m in module._modules.items()},
    }
    if init_kwargs is not None:
        state["_init_args"] = ()
        state["_init_kwargs"] = init_kwargs
    return {"type": "class", "version": 6, "class_name": class_name, "state": state,
            "module_src": "raise RuntimeError('the embedded class source was run')"}


def write_eg3d_pickle(module, init_kwargs, path, form):
    """An EG3D network pickle {'G_ema': module} at `path`: every module a
    reduce call to torch_utils.persistence._reconstruct_persistent_obj(meta);
    `form` 'pickle.dump' (EG3D's own) or 'torch.save'."""
    import pickle
    import types

    import torch

    def _reconstruct_persistent_obj(meta):  # named in the pickle; the converter never calls it
        raise AssertionError("the converter rebuilt a module")

    class Persistent:
        def __init__(self, meta):
            self.meta = meta

        def __reduce__(self):
            return (_reconstruct_persistent_obj, (self.meta,))

    def wrap(meta):
        state = meta["state"]
        return Persistent({**meta, "state": {**state, "_modules": {
            k: wrap(m) for k, m in state["_modules"].items()}}})

    pers = types.ModuleType("torch_utils.persistence")
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    _reconstruct_persistent_obj.__module__ = pers.__name__
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    names = ("torch_utils", "torch_utils.persistence")
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update({"torch_utils": types.ModuleType("torch_utils"), pers.__name__: pers})
    try:
        payload = {"G_ema": wrap(persistence_meta(module, "TriPlaneGenerator", init_kwargs))}
        if form == "torch.save":
            torch.save(payload, path)
        else:
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=4)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def sg_loss_and_grad(g, lpips, target, camera, w, noise, render_draws):
    """One float32 'sg' projector step's loss and gradient of w, from w with
    the given noise maps and renderer draws (no w noise)."""
    import torch

    from spi_tpu_torch.training.projectors import ProjectorSettings, _fixed, _image_loss

    w = w.clone().requires_grad_(True)
    loss, _ = _image_loss(g, lpips, ProjectorSettings(mode="sg", num_steps=1), noise, w,
                          torch.zeros_like(w), 0.0, _fixed(lpips, "sg", target, camera),
                          render_draws)
    loss.backward(inputs=[w])
    return loss.detach(), w.grad


def phase_convert(dev):
    """Converted weights drive the inversion at full width: the seeded
    ffhq512_128_config generator written as an EG3D persistence pickle in
    both forms (pickle.dump, EG3D's own, and torch.save), each converted by
    `python -m spi_tpu_torch.convert eg3d` in a process of its own (the two
    at once), every array equal to its source tensor bitwise and the json
    to the init kwargs; the npz loaded into a fresh generator on the card;
    one float32 'sg' step's loss and gradient of w from the converted
    weights against the source module's, on the same draws, within
    TOL_SYNTH (the splat's f32 atomics add in run-dependent order)."""
    import dataclasses
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.models.rendering.renderer import draw_randoms
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils import camera as cam
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.params import extract_noise

    here = Path(__file__).resolve().parent
    root = here / "build" / "convert"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    src = TriPlaneGenerator(ffhq512_128_config(), device=dev, seed=0)
    want = {k: v.cpu().numpy() for k, v in src.state_dict().items()}
    n_weights = sum(p.numel() for p in src.parameters())
    n_entries = sum(v.size for v in want.values())
    init_kwargs = dataclasses.asdict(src.cfg)
    t0 = time.perf_counter()
    procs = {}
    for form in ("pickle.dump", "torch.save"):
        pkl = root / f"{form}.pkl"
        write_eg3d_pickle(src, init_kwargs, pkl, form)
        procs[form] = subprocess.Popen(
            [sys.executable, "-m", "spi_tpu_torch.convert", "eg3d", str(pkl),
             str(root / f"{form}.npz")], cwd=here, env=dict(os.environ, PYTHONPATH=str(here)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for form, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"convert eg3d on the {form} pickle failed: {out[-2000:]}")
        size = (root / f"{form}.pkl").stat().st_size
        log(f"convert: the {form} pickle, {size / 2**20:.1f} MiB, {n_weights} weights and "
            f"{n_entries - n_weights} buffer entries: "
            f"{out.strip().splitlines()[-1]}")
    log(f"convert: both pickles written and converted in {time.perf_counter() - t0:.1f} s")
    for form in procs:
        flat = load_npz(str(root / f"{form}.npz"))
        check(sorted(flat) == sorted(want), f"the {form} npz has other keys than the module")
        bad = [k for k in want
               if flat[k].dtype != np.float32 or not np.array_equal(flat[k], want[k])]
        check(not bad, f"the {form} npz differs from its source tensors: {bad[:4]}")
        with open(root / f"{form}.npz.json") as f:
            check(json.load(f) == json.loads(json.dumps(init_kwargs, default=str)),
                  f"the {form} json is not the init kwargs")
    log(f"convert: both npz files equal the source's {len(want)} tensors bitwise")

    g = TriPlaneGenerator(ffhq512_128_config(), device=dev, seed=1)
    load_flat_params(g, load_npz(str(root / "pickle.dump.npz")))
    lpips = LPIPS(device=dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    res = src.cfg.img_resolution
    target = torch.tanh(torch.randn(1, 3, res, res, device=dev, generator=gen))
    camera = cam.canonical_camera(device=dev)
    with torch.no_grad():
        w = src.mapping(torch.randn(1, src.z_dim, device=dev, generator=gen), camera)[:, :1]
    noise = {k: v.clone() for k, v in extract_noise(src).items()}
    nrr = src.cfg.neural_rendering_resolution
    draws = draw_randoms(src.cfg.rendering, 1, nrr * nrr, dev, gen)
    _lib.reset_launch_counts()
    runs = {name: sg_loss_and_grad(m, lpips, target, camera, w, noise, draws)
            for name, m in (("source", src), ("converted", g))}
    launches = dict(_lib.launch_counts)
    (loss_s, grad_s), (loss_c, grad_c) = runs["source"], runs["converted"]
    loss_err = float((loss_c - loss_s).abs() / loss_s.abs())
    grad_err = rel_err(grad_c, grad_s)
    log(f"convert: 'sg' step from the converted weights against the source module: loss "
        f"{float(loss_c):.6f} / {float(loss_s):.6f} (rel err {loss_err:.2e}), gradient of w rel "
        f"err {grad_err:.2e} (tol {TOL_SYNTH}); launches {launches}")
    check(math.isfinite(loss_err) and loss_err <= TOL_SYNTH, f"convert: loss {loss_err:.3e}")
    check(math.isfinite(grad_err) and grad_err <= TOL_SYNTH, f"convert: w gradient {grad_err:.3e}")
    for k in INVERSION_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the converted-weights path")
    del src, g, lpips, runs


def phase_native_loader():
    """data/native_loader.py on this machine's host: where native/libspi_io.so
    loads, a prefetch batch of four 64² PNGs equal to PIL's decode (PNG is
    lossless and no resize is made, so to 1e-6) and a bad file marked;
    where it does not, `available()` is False (spi_tpu's behaviour)."""
    import ctypes
    import shutil
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from spi_tpu_torch.data import native_loader

    if not native_loader.available():
        try:
            ctypes.CDLL(str(Path(__file__).resolve().parent / "native" / "libspi_io.so"))
            reason = "it loads now"
        except OSError as e:
            reason = str(e)
        log(f"native loader: native/libspi_io.so does not load on this machine ({reason}); "
            "available() is False and decode_image returns None")
        return
    root = Path(__file__).resolve().parent / "build" / "native_loader"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(4)]
    paths = []
    for i, a in enumerate(arrays):
        Image.fromarray(a).save(root / f"{i}.png")
        paths.append(str(root / f"{i}.png"))
    (root / "bad.png").write_bytes(b"broken")
    loader = native_loader.NativeLoader(paths + [str(root / "bad.png")], out_size=64, batch=5,
                                        n_threads=1, shuffle=False)
    try:
        t0 = time.perf_counter()
        imgs, idx = loader.next()
        first_s = time.perf_counter() - t0
    finally:
        loader.close()
    check(sorted(idx.tolist()) == [-5, 0, 1, 2, 3], f"native loader indices {idx.tolist()}")
    for slot, i in enumerate(idx.tolist()):
        if i < 0:
            check(not imgs[slot].any(), "the bad file's slot is not zero-filled")
            continue
        want = arrays[i].astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        check(float(np.abs(imgs[slot] - want).max()) <= 1e-6, f"native loader image {i}")
    log(f"native loader: a batch of 4 PNGs and a bad file in {first_s * 1e3:.1f} ms, equal to "
        "PIL's decode; the bad file marked")


def phase_sg3(dev):
    """StyleGAN3-T FFHQ-1024 at its published widths, float32, batch 1,
    seeded weights: a forward and a backward (finite, and the launches of
    each), the largest bias_act call's inputs kernel against plain version
    bitwise (KernelInputs), and last one magnitude EMA renewed
    (update_emas) against its rule on the layer's input. Returns the
    launches of one forward + backward."""
    import torch

    from spi_tpu_torch.models.stylegan3 import SG3Generator
    from spi_tpu_torch.ops import _lib

    g = SG3Generator(**SG3_T, device=dev, seed=0)
    entries = sum(v.numel() for v in g.state_dict().values())
    check(entries == SG3_T_ENTRIES, f"SG3-T has {entries} entries, not {SG3_T_ENTRIES}")
    gen = torch.Generator().manual_seed(23)
    z = torch.randn(1, SG3_T["z_dim"], generator=gen).to(dev)
    res = SG3_T["img_resolution"]
    r = torch.randn(1, 3, res, res, generator=gen).to(dev)

    def fwd_bwd():
        g.zero_grad(set_to_none=True)
        y = g(z, None)
        (y * r).sum().backward()
        return y

    _lib.reset_launch_counts()
    y = g(z, None)
    fwd_n = dict(_lib.launch_counts)
    (y * r).sum().backward()
    bwd_n = {k: v - fwd_n[k] for k, v in _lib.launch_counts.items()}
    launches = {k: fwd_n[k] + bwd_n[k] for k in fwd_n}
    check(tuple(y.shape) == (1, 3, res, res) and bool(torch.isfinite(y).all()),
          "SG3-T output not finite or of the wrong shape")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in g.parameters()), "SG3-T: a parameter gradient is missing or not finite")
    layers = len(g.synthesis.layer_names)
    log(f"SG3-T launches: one forward {fwd_n['filtered_lrelu_fwd']} filtered_lrelu_fwd (one in "
        f"each of the {layers} layers) and {fwd_n['bias_act_fwd']} bias_act_fwd (the affines "
        f"and the mapping), one backward {bwd_n['filtered_lrelu_bwd']} filtered_lrelu_bwd, "
        f"{bwd_n['filtered_lrelu_bias_grad']} filtered_lrelu_bias_grad and "
        f"{bwd_n['bias_act_bwd']} bias_act_bwd; all {launches}")
    for k in SG3_KERNELS:
        check(launches[k] > 0, f"kernel {k} was never launched on the SG3 path")
    check(fwd_n["filtered_lrelu_fwd"] == layers and bwd_n["filtered_lrelu_bwd"] == layers,
          f"SG3-T: {fwd_n['filtered_lrelu_fwd']} / {bwd_n['filtered_lrelu_bwd']} fused "
          f"filtered_lrelu launches a pass, not one in each of the {layers} layers")
    check(not any(launches[k] for k in SG3_UNFUSED),
          f"SG3-T launched the composition's kernels: {[(k, launches[k]) for k in SG3_UNFUSED]}")
    del y

    with KernelInputs() as rec:
        fwd_bwd()
    g.zero_grad(set_to_none=True)
    check({"bias_act_fwd", "bias_act_bwd"} <= set(rec.calls),
          f"SG3 made no call to {sorted({'bias_act_fwd', 'bias_act_bwd'} - set(rec.calls))}")
    torch.cuda.empty_cache()
    errs = check_kernel_inputs(rec.calls, rec.originals, "SG3-T")
    del rec
    log("SG3-T kernel inputs, max abs err against the plain versions: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(all(v == 0 for v in errs.values()), f"SG3-T: a float32 bias_act call is not bitwise {errs}")

    name = g.synthesis.layer_names[10]
    layer = getattr(g.synthesis, name)
    seen = {}
    hook = layer.register_forward_pre_hook(lambda m, args: seen.update(x=args[0].double()))
    old = float(layer.magnitude_ema)
    try:
        with torch.no_grad():
            g(z, None, update_emas=True)
    finally:
        hook.remove()
    cur = float(seen["x"].square().mean())
    want = cur + layer.magnitude_ema_beta * (old - cur)
    new = float(layer.magnitude_ema)
    log(f"SG3-T magnitude EMA of {name}: {old:.6f} -> {new:.6f} (its input's mean square "
        f"{cur:.6f}; the rule gives {want:.6f})")
    check(abs(new - want) <= 1e-5 * abs(want), f"SG3-T magnitude EMA {new} against {want}")
    del g, seen
    torch.cuda.empty_cache()
    return launches


def graph_check_trainers(dev, size):
    """The editing trainers the graph check compares: 'tiny'
    (tiny_test_config twins with noise strengths 0.1, tiny_test_clip),
    'eg3d' (ffhq512_128_config twins and ViT-B/32 + ViT-B/16 at their
    published widths: edit_clip_b2's) or 'sg3' (StyleGAN3-T FFHQ-1024 twins
    and the same CLIP models: edit_sg3t_b2's); batch 2, the direction term
    only, seeded weights. Returns make(seed) -> a trainer with the
    text-side state, all on one frozen generator."""
    import zlib

    import torch

    from spi_tpu_torch.cli.run_editing import CRCTokenizer
    from spi_tpu_torch.editing import DirectionalCLIPLoss, EditingSettings, ZSSGANTrainer
    from spi_tpu_torch.editing.zssgan2d import ZSSGANSG3Trainer
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config, tiny_test_config
    from spi_tpu_torch.models.perception import clip as clip_models
    from spi_tpu_torch.models.stylegan3 import SG3Generator

    if size == "sg3":
        frozen = SG3Generator(**SG3_T, device=dev, seed=0)
    else:
        frozen = TriPlaneGenerator(tiny_test_config() if size == "tiny" else ffhq512_128_config(),
                                   device=dev, seed=0)
    if size == "tiny":
        with torch.no_grad():
            for name, t in frozen.named_parameters():
                if name.endswith("noise_strength"):
                    t.fill_(0.1)
        configs = {"tiny": clip_models.tiny_test_clip()}
    else:
        configs = {name: getattr(clip_models, cfg)() for name, cfg in EDIT_CLIPS}
    losses = {name: DirectionalCLIPLoss(clip_models.CLIP(
        cfg, device=dev, seed=zlib.crc32(name.encode()) % 2**31)) for name, cfg in configs.items()}
    cls = ZSSGANSG3Trainer if size == "sg3" else ZSSGANTrainer
    tokenizer = CRCTokenizer(next(iter(configs.values())).vocab_size)
    states = {}

    def make(seed):
        tr = cls(frozen, losses, {name: 1.0 for name in losses}, EditingSettings(), device=dev,
                 seed=seed)
        if not states:
            states.update(tr.build_states(tokenizer))
        tr.states = states
        return tr

    return make


def trace_kernels(prof):
    """The kernel events of a profiler's Chrome trace, as benchmark/harness/
    trace.py reads them: their names."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]


def phase_graph_step(dev, steps=5, seed=7):
    """The editing step replayed as one CUDA graph against the same step
    issued operator by operator, at the tiny size and at edit_clip_b2's and
    edit_sg3t_b2's widths. From one seed, so on the same draws: `steps`
    graphed steps (`step`: step 0 eager, step 1 captured and replayed, the
    rest replayed) and three runs of `steps` eager steps (`eager_step`).
    The graphed run lies within twice the eager runs' spread of each of
    them: the largest relative gap over the losses, and over the trained
    leaves the norm of the changes' gap over the norm of the change (as
    the benchmark's `change`: the splat's atomics and Adam's first updates,
    about lr * sign(g), turn rounding into flips of whole entries), each
    the largest over the pairs of runs (bitwise where the eager runs agree
    bitwise); the graphed run's generator ends where the eager runs' do; a
    replay counts an eager step's launches. A trainer captured and replayed
    under torch.profiler lists in the Chrome trace, for each replay, the
    kernels of an eager step within 3% (the port's kernels among them).
    Returns {size: the launches of a replay}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spi_tpu_torch.ops import _lib

    out = {}
    for size in ("tiny", "eg3d", "sg3"):
        make = graph_check_trainers(dev, size)

        def run(graphed):
            tr = make(seed)
            check(tr.graphed, f"graph check {size}: the trainer on the card is not graphed")
            losses, launches = [], []
            for _ in range(steps):
                before = dict(_lib.launch_counts)
                losses.append(float(tr.step() if graphed else tr.eager_step()))
                launches.append({k: n - before[k] for k, n in _lib.launch_counts.items()
                                 if n != before[k]})
            start = dict(tr.frozen.named_parameters())
            changes = {k: p.detach() - start[k] for k, p in tr.trainable.named_parameters()
                       if k in tr.mask}
            return tr, losses, launches, changes, tr.rng.get_state()

        _, g_losses, g_launches, g_leaves, g_rng = run(True)
        eager = [run(False) for _ in range(3)]
        _, e_losses, e_launches, e_leaves, e_rng = eager[0]
        twin = eager[-1][0]

        def loss_gap(a, b):
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        def change_gap(a, b):
            return max(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b)

        pairs = [(eager[i], eager[j]) for i in range(3) for j in range(i + 1, 3)]
        loss_spread = max(loss_gap(a[1], b[1]) for a, b in pairs)
        spread = max(change_gap(a[3], b[3]) for a, b in pairs)
        loss_err = max(loss_gap(g_losses, e[1]) for e in eager)
        err = max(change_gap(g_leaves, e[3]) for e in eager)
        log(f"graph check {size}: losses graphed {g_losses}, eager {e_losses}; loss gap "
            f"{loss_err:.3e} against the eager runs' {loss_spread:.3e}; the {len(g_leaves)} "
            f"trained leaves' changes {err:.3e} against the eager runs' {spread:.3e}")
        check(loss_err <= 2 * loss_spread, f"graph check {size}: the graphed losses stray "
              f"{loss_err:.3e}, the eager runs {loss_spread:.3e}")
        check(err <= 2 * spread, f"graph check {size}: the graphed changes stray {err:.3e}, "
              f"the eager runs {spread:.3e}")
        check(all(torch.equal(g_rng, e[4]) for e in eager),
              f"graph check {size}: the generators end apart")
        check(all(n == e_launches[-1] for n in g_launches[2:] + e_launches[1:]),
              f"graph check {size}: a replay launches {g_launches[2:]}, an eager step "
              f"{e_launches[1:]}")
        out[size] = g_launches[-1]

        # Kernels of an eager step and of a capture and two replays under
        # the profiler, as the benchmark's trace reads them.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(twin.eager_step())
        eager_kernels = trace_kernels(prof)
        del twin, eager
        tr = make(seed)
        float(tr.step())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                float(tr.step())
        replayed = trace_kernels(prof)
        ours = sorted({k for k in replayed
                       if any(w in k for w in ("plane_s", "bias_act", "filtered_lrelu"))})
        n = len(eager_kernels)
        log(f"graph check {size}: an eager step traces {n} kernels, a capture and two "
            f"replays {len(replayed)}; the port's: {ours}; launches a replay {out[size]}")
        check(abs(len(replayed) - 2 * n) <= 0.03 * 2 * n and ours,
              f"graph check {size}: the trace lists {len(replayed)} kernels of two replays "
              f"against {n} of an eager step")
        del tr, make
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another checkout (e.g. a git archive under build/) whose splat, "
                    "win_scatter and row_scatter_add kernels phase 2 times in turns with this "
                    "one; may be given more than once")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from spi_tpu_torch.ops import _lib
    from spi_tpu_torch.utils.device import resolve_device

    dev = resolve_device(torch.device("cuda", 0))  # TF32 off, as every entry point
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
    models = {"float32": model, "bfloat16": build_model(dev, "bfloat16")}
    kernels = phase(2, "kernels vs plain", lambda: [
        phase_splat(dev, model, args.parent), *phase_plane_sample(dev, model),
        *phase_bias_act(dev), phase_bias_act_grad2(dev),
        *phase_bias_act_bf16(dev),
        phase_win_scatter(dev, args.parent),
        phase_row_gather(dev), phase_row_scatter_add(dev, args.parent),
        *phase_upfirdn2d(dev), *phase_filtered_lrelu(dev)])
    phase(2, "kernels under vmap", phase_vmap_kernels, dev)
    phase(2, "Hessian-vector product through the lookup", phase_lookup_hvp, dev)
    phase(3, "tiny synthesis card vs CPU", phase_tiny_synthesis, dev)
    phase(3, "tiny RotBbox step card vs CPU", phase_tiny_rotbbox, dev)
    phase(3, "tiny ZSSGAN step card vs CPU", phase_tiny_zssgan, dev)
    phase(3, "tiny GAN step (R1, density TV) card vs CPU", phase_tiny_gan, dev)
    phase(3, "tiny StyleGAN3 forward and backward card vs CPU", phase_tiny_sg3, dev)
    # The 'sg' run of each dtype gives the pivot and the launch counts.
    pivots, launches = {}, {}
    for dtype, m in models.items():
        pivots[dtype], launches[dtype] = phase(4, f"sg projection {dtype}", phase_project, dev,
                                               m, dtype)
    for dtype, m in models.items():
        phase(6, f"mir projection {dtype}", phase_mir, dev, m, 4, dtype)
    for dtype, m in models.items():
        phase(7, f"stage-2 tuning {dtype}", phase_tune, dev, m, pivots[dtype], 6, dtype)
    phase(8, "probe tools", phase_tools, dev)
    for dtype, m in models.items():
        phase(9, f"RotBbox tuning {dtype}", phase_rotbbox, dev, m, pivots[dtype], 9, dtype)
    for dtype in models:
        phase(10, f"inversion CLI {dtype}", phase_cli, dev, dtype)
    del models, model, pivots
    torch.cuda.empty_cache()
    data = phase(11, "preprocess", phase_preprocess, dev)
    phase(12, "inversion --save_video and run_video on the preprocessed tree",
          phase_user_path, dev, data)
    torch.cuda.empty_cache()
    phase(14, "batched against serial, float32", phase_batched_vs_serial, dev)
    phase(15, "batched launches at B = 1, 2, 4", phase_batch_launches, dev)
    phase(16, "inversion CLI --parallel_images 4", phase_cli_batched, dev)
    phase(17, "two processes, --dataset_block auto", phase_two_processes, dev)
    torch.cuda.empty_cache()
    phase(18, "CLIP-guided editing at full width, float32", phase_editing, dev)
    torch.cuda.empty_cache()
    phase(19, "the editing CLIs", phase_editing_clis, dev)
    torch.cuda.empty_cache()
    gan_launches = phase(20, "GAN training at full width", phase_gan, dev)
    torch.cuda.empty_cache()
    phase(21, "the GAN CLI and two processes", phase_gan_cli, dev)
    torch.cuda.empty_cache()
    phase(22, "converted EG3D pickles drive an 'sg' step at full width", phase_convert, dev)
    phase(22, "the native image loader on the host", phase_native_loader)
    sg3_launches = phase(23, "StyleGAN3-T FFHQ-1024 at full width", phase_sg3, dev)
    torch.cuda.empty_cache()
    phase(24, "the editing step as one CUDA graph against eager steps", phase_graph_step, dev)
    from spi_tpu_torch.ops.plane_splat import contiguous_copies

    log(f"strided inputs the lookup copied in the whole run: {contiguous_copies}")
    for k in kernels:  # launches on the inversion ('sg') path of the kernel's dtype
        dtype = "bfloat16" if k["name"].endswith("_bf16") else "float32"
        k["launches"] = launches[dtype][k["name"]]
        k["gan_launches"] = gan_launches[k["name"]]  # in a plain GAN step (phase 20)
        k["sg3_launches"] = sg3_launches[k["name"]]  # in one SG3-T forward + backward (23)
    # The second-order form is on no inversion path; its path is GAN
    # training's R1 step, where D's lrelu and linear need none of it.
    grad2 = next(k for k in kernels if k["name"] == "bias_act_grad2")
    grad2["launches"] = gan_launches["bias_act_grad2"]
    check([k["name"] for k in kernels] == list(_lib.KERNELS), "a kernel is missing from phase 2")

    from spi_tpu_torch.tools.timing import card_label

    print(card_label(dev))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
