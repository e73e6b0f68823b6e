"""upfirdn2d's autograd Function and the kernel's algorithm, on the CPU.

- `_Upfirdn2d` on CPU tensors loads no kernel library and launches
  nothing, and its forward is `upfirdn2d_plain` bitwise on every caller's
  case (the FIR after a transposed convolution, the ToRGB skip,
  downsample2d, StyleGAN3's up and down filters, the identity with a pad,
  up and down 1, 2 and 4, negative pads, flip and gain, 1-D and 2-D
  filters) in float32, bfloat16 and float64.
- Its backward, the Function on the adjoint problem, equals autograd of
  `upfirdn2d_plain` in float64; `gradgradcheck` passes; under
  `vmap_strict` the forward and the gradient equal a loop over the images.
- `upfirdn2d_cuda` raises on what the kernel does not take.
- The kernel's algorithm restated in numpy (each form's tiles, the
  shift that makes the pad whole input pixels, the polyphase taps, the
  shared-memory extents, the tap folding) against `upfirdn2d_plain`, with
  its tile and limit constants read from `csrc/upfirdn2d.cu`.
- Every `__global__` kernel of the source counts as convolution work for
  the benchmark's `conv_ms_per_step`.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops.upfirdn2d import (
    MAX_FACTOR,
    MAX_TAPS,
    _Upfirdn2d,
    setup_filter,
    upfirdn2d,
    upfirdn2d_cuda,
    upfirdn2d_plain,
)
from spi_tpu_torch.utils.params import vmap_strict
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "spi_tpu_torch" / "csrc" / "upfirdn2d.cu").read_text()


def _sg3_filter(taps, seed):
    """A normalized 1-D low-pass-like filter of `taps` taps with negative
    lobes, as StyleGAN3's Kaiser designs are."""
    f = np.sinc(np.linspace(-2.5, 2.5, taps)) + 0.01 * np.random.RandomState(seed).randn(taps)
    return torch.tensor(f / f.sum(), dtype=torch.float32)


BINOMIAL = setup_filter([1, 3, 3, 1])
# (filter, up, down, padding (x0, x1, y0, y1), gain) of each caller.
CASES = {
    # conv2d_resample's up block: after the transposed convolution, and its adjoint.
    "transposed conv FIR": (BINOMIAL, 1, 1, (1, 1, 1, 1), 4.0),
    "its adjoint": (BINOMIAL, 1, 1, (2, 2, 2, 2), 4.0),
    # upsample2d on a ToRGB skip, and its adjoint.
    "ToRGB skip": (BINOMIAL, 2, 1, (2, 1, 2, 1), 4.0),
    "skip adjoint": (BINOMIAL, 1, 2, (1, 1, 1, 1), 4.0),
    # downsample2d / conv2d_resample's down branches.
    "down 2": (BINOMIAL, 1, 2, (1, 1, 1, 1), 1.0),
    "up 4": (BINOMIAL, 4, 1, (3, 2, 3, 2), 16.0),
    "down 4": (BINOMIAL, 1, 4, (0, 3, 2, 1), 1.0),
    "crop": (BINOMIAL, 1, 1, (-1, 2, 0, -1), 1.0),
    "up 2 odd pad": (BINOMIAL, 2, 1, (1, 2, 3, 0), 4.0),
    # StyleGAN3's filtered_lrelu: 1-D up filters at 2x and 4x, the down
    # filter, a radial 2-D down filter, and the ToRGB layer's identity.
    "sg3 up 2": (_sg3_filter(12, 1), 2, 1, (9, 8, 9, 8), 4.0),
    "sg3 up 4": (_sg3_filter(24, 2), 4, 1, (13, 12, 13, 12), 16.0),
    "sg3 down 2": (_sg3_filter(12, 3), 1, 2, (0, 0, 0, 0), 1.0),
    "sg3 radial down": (torch.outer(_sg3_filter(12, 4), _sg3_filter(12, 5)), 1, 2,
                        (0, 0, 0, 0), 1.0),
    "identity pad": (None, 1, 1, (1, 1, 1, 1), 1.0),
    "rectangular": (torch.randn(3, 5, generator=torch.Generator().manual_seed(6)), (2, 1),
                    (1, 2), (2, 1, 0, 3), 1.5),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def _pairs(v):
    return tuple(v) if isinstance(v, tuple) else (v, v)


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).to(dtype)


def _args(case, flip=False, gain=None, dtype=torch.float32):
    f, up, down, pad, g = CASES[case]
    return (None if f is None else f.to(dtype), _pairs(up), _pairs(down), pad, flip,
            g if gain is None else gain)


@pytest.fixture
def no_library(monkeypatch):
    """Fails a test that reaches the kernel library; launch counts at 0."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_lib, "lib", refuse)
    _lib.reset_launch_counts()
    yield
    assert not any(_lib.launch_counts.values()), _lib.launch_counts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_is_plain_on_cpu(no_library, case, dtype):
    x = _x((2, 3, 19, 21), DTYPES[dtype], seed=len(case))
    for flip, gain in ((False, None), (True, 2.5)):
        f, up, down, pad, flip, gain = _args(case, flip, gain)
        want = upfirdn2d_plain(x, f, up, down, pad, flip, gain)
        assert torch.equal(_Upfirdn2d.apply(x, f, up, down, pad, flip, gain), want)
        assert torch.equal(upfirdn2d(x, f, up, down, pad, flip, gain), want)
        assert want.dtype == x.dtype


@pytest.mark.parametrize("case", list(CASES))
def test_backward_is_the_adjoint(no_library, case):
    for flip in (False, True):
        f, up, down, pad, flip, gain = _args(case, flip, dtype=torch.float64)
        x = _x((2, 3, 15, 13), torch.float64, seed=3).requires_grad_(True)
        y = _Upfirdn2d.apply(x, f, up, down, pad, flip, gain)
        g = _x(y.shape, torch.float64, seed=4)
        (got,) = torch.autograd.grad(y, x, g)
        (want,) = torch.autograd.grad(upfirdn2d_plain(x, f, up, down, pad, flip, gain), x, g)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("case", ["transposed conv FIR", "ToRGB skip", "skip adjoint",
                                  "sg3 up 2", "rectangular"])
def test_gradgradcheck(no_library, case):
    f, up, down, pad, flip, gain = _args(case, dtype=torch.float64)
    x = _x((1, 2, 7, 6), torch.float64, seed=5).requires_grad_(True)
    assert torch.autograd.gradgradcheck(
        lambda x: _Upfirdn2d.apply(x, f, up, down, pad, flip, gain), (x,))


@pytest.mark.parametrize("case", ["transposed conv FIR", "ToRGB skip", "sg3 down 2"])
def test_vmap_strict_equals_a_loop(no_library, case):
    f, up, down, pad, flip, gain = _args(case, dtype=torch.float64)
    xs = _x((3, 2, 4, 14, 13), torch.float64, seed=6)

    def fwd(x):
        return _Upfirdn2d.apply(x, f, up, down, pad, flip, gain)

    want = torch.stack([fwd(x) for x in xs])
    assert torch.equal(vmap_strict(fwd)(xs), want)
    gs = _x(want.shape, torch.float64, seed=7)

    def grad(x, g):
        return torch.func.vjp(fwd, x)[1](g)[0]

    torch.testing.assert_close(vmap_strict(grad)(xs, gs),
                               torch.stack([grad(x, g) for x, g in zip(xs, gs)]),
                               rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="one filter"):
        vmap_strict(lambda x, f: _Upfirdn2d.apply(x, f, up, down, pad, flip, gain))(
            xs, torch.stack([f] * 3))


def test_cuda_wrapper_rejects(no_library):
    x = torch.zeros(1, 2, 8, 8)
    f = BINOMIAL
    for bad, match in (
            ((x.double(), f), "float32 or bfloat16"),
            ((x.half(), f), "float32 or bfloat16"),
            ((x.transpose(2, 3), f), "contiguous"),
            ((x[0], f), "NCHW"),
            ((x, torch.ones(MAX_TAPS + 1) / 33), "at most 32 taps"),
            ((x, torch.ones(4, MAX_TAPS + 1)), "at most 32 taps"),
            ((x, f.double()), "filter must be"),
            ((x, f.t()), "filter must be"),
            ((x, torch.ones(2, 2, 2)), "filter must be")):
        with pytest.raises(ValueError, match=match):
            upfirdn2d_cuda(*bad)
    with pytest.raises(ValueError, match="factors"):
        upfirdn2d_cuda(x, f, up=(MAX_FACTOR + 1, 1))
    with pytest.raises(ValueError, match="smaller than filter"):
        upfirdn2d_cuda(x, f, padding=(-3, -3, 0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        upfirdn2d_cuda(x, f)


def _constant(name):
    m = re.search(rf"\b{name} = (\d+)[;,]", SOURCE)
    assert m, name
    return int(m.group(1))


def test_limits_match_the_source():
    assert _constant("kMaxTaps") == MAX_TAPS
    assert _constant("kMaxFactor") == MAX_FACTOR


def test_kernel_names_count_as_convolutions():
    spec = importlib.util.spec_from_file_location(
        "conv_ms_per_step", ROOT / "benchmark" / "metrics" / "conv_ms_per_step.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", SOURCE)
    assert len(names) == 3, names
    for name in names:
        # As a profiler names a template instance.
        assert metric.is_conv(f"void (anonymous namespace)::{name}<__nv_bfloat16, 1, 1, 4>(...)")


# --- The kernel's algorithm, restated -------------------------------------


def _tiled_forms():
    """(up, down, MX, MY, BX, BY) of each compile-time form: its up and down
    factors, outputs a thread and threads a block along x and y."""
    return [tuple(int(v) for v in m) for m in re.findall(
        r"launch_tiled<T, (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>", SOURCE)]


def _shift(pad0, up, n):
    """csrc shift_axis: zero taps s in front, pad p0 in input pixels, taps k."""
    s = (-pad0) % up
    return s, (pad0 + s) // up, (s + n + up - 1) // up * up


def _round_taps(v, dtype):
    return torch.from_numpy(v).to(dtype).to(torch.float64).numpy() if dtype == torch.bfloat16 \
        else v.astype(np.float64)


def _kernel_taps(f, gain, flip, sx, sy, kw, kh, dtype):
    """The shifted taps of load_taps: float32 folding (f[i] * f[j], then *
    gain), flipped unless flip, rounded to bf16 for a bf16 x. (The plain
    version too casts the filter to float32 first, whatever x's dtype.)"""
    if f is None:
        w = np.full((1, 1), gain, np.float32)
    else:
        a = f.numpy().astype(np.float32)
        w = (np.outer(a, a) if a.ndim == 1 else a) * np.float32(gain)
        if not flip:
            w = w[::-1, ::-1]
    out = np.zeros((kh, kw))
    out[sy:sy + w.shape[0], sx:sx + w.shape[1]] = _round_taps(np.ascontiguousarray(w), dtype)
    return out


def _smem_tile(x, iy0, ix0, rows, cols):
    """load_tile: rows x cols of one plane from (iy0, ix0), zero outside."""
    h, w = x.shape
    out = np.zeros((rows, cols))
    ys, xs = np.arange(iy0, iy0 + rows), np.arange(ix0, ix0 + cols)
    vy, vx = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    out[np.ix_(vy, vx)] = x[np.ix_(ys[vy], xs[vx])]
    return out


def _emulate(x, f, up, down, pad, flip, gain, form, dtype=torch.float64):
    """The kernel's arithmetic on one (H, W) float64 plane: `form` is
    ("tiled", up, down, MX, MY, BX, BY), ("generic",) or ("separable",)."""
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = up, down, pad
    h, w = x.shape
    fh, fw = (1, 1) if f is None else (f.shape[0], f.shape[-1])
    out_h = (h * upy + py0 + py1 - fh) // downy + 1
    out_w = (w * upx + px0 + px1 - fw) // downx + 1
    sx, p0x, kw = _shift(px0, upx, fw)
    sy, p0y, kh = _shift(py0, upy, fh)
    y = np.full((out_h, out_w), np.nan)
    if form[0] == "tiled":
        _, tu, td, mx, my, bx, by = form
        assert (upx, upy, downx, downy, kw, kh) == (tu, tu, td, td, 4, 4)
        tw, th = bx * mx, by * my
        rx, ry = ((mx - 1) * td + 3) // tu + 1, ((my - 1) * td + 3) // tu + 1
        col_step, row_step = mx * td // tu, my * td // tu
        rxv = (rx + 3) // 4 * 4
        taps = _kernel_taps(f, gain, flip, sx, sy, 4, 4, dtype)
        # csrc extend(): where an axis has a thin rest past whole tiles (at
        # most one micro-tile), its last whole tile takes it, one output a
        # thread from the tile's shared memory.
        ext = [n > t and 0 < n % t <= m for n, t, m in ((out_h, th, my), (out_w, tw, mx))]
        along = [n // t if e else -(-n // t) for n, t, e in ((out_h, th, ext[0]),
                                                               (out_w, tw, ext[1]))]
        # Every tile loads the input of a tile extended along both axes.
        rows, cols = ((th + my - 1) * td + 3) // tu + 1, ((tw + mx - 1) * td + 3) // tu + 1
        stride = max((bx - 1) * col_step + rxv, cols + 3) // 4 * 4
        assert col_step % 4 == 0
        for oy_t in range(0, along[0] * th, th):
            for ox_t in range(0, along[1] * tw, tw):
                tall = ext[0] and oy_t == (along[0] - 1) * th
                wide = ext[1] and ox_t == (along[1] - 1) * tw
                xs = np.zeros((rows, stride))
                xs[:, :cols] = _smem_tile(x, oy_t * td // tu - p0y, ox_t * td // tu - p0x,
                                          rows, cols)
                extension = [(ly, tw + i) for ly in range(th + my * tall) for i in range(mx)
                             if wide] + [(th + j, lx) for j in range(my) for lx in range(tw)
                                         if tall]
                for ly, lx in extension:
                    oy, ox = oy_t + ly, ox_t + lx
                    if oy >= out_h or ox >= out_w:
                        continue
                    ky0, kx0 = (-ly * td) % tu, (-lx * td) % tu
                    r0, c0 = (ly * td + ky0) // tu, (lx * td + kx0) // tu
                    assert r0 + 4 // tu <= rows and c0 + 4 // tu <= cols
                    assert np.isnan(y[oy, ox])
                    y[oy, ox] = np.sum(xs[r0:r0 + 4 // tu, c0:c0 + 4 // tu]
                                       * taps[ky0::tu, kx0::tu])
                for ty in range(by):
                    for tx in range(bx):
                        r0, c0 = ty * row_step, tx * col_step
                        assert r0 + ry <= rows and c0 + rxv <= stride
                        win = xs[r0:r0 + ry, c0:c0 + rx]
                        for j in range(my):
                            for i in range(mx):
                                oy, ox = oy_t + ty * my + j, ox_t + tx * mx + i
                                acc = 0.0
                                for r in range(ry):
                                    ky = tu * r - j * td
                                    for c in range(rx):
                                        kx = tu * c - i * td
                                        if 0 <= ky < 4 and 0 <= kx < 4:
                                            acc += win[r, c] * taps[ky, kx]
                                if oy < out_h and ox < out_w:
                                    assert np.isnan(y[oy, ox])
                                    y[oy, ox] = acc
        return y
    separable = form[0] == "separable"
    tw, th = (_constant("SW"), _constant("SH")) if separable else (32, 256 // 32)
    assert separable or (_constant("GW"), _constant("kThreads")) == (32, 256)
    in_w = ((tw - 1) * downx + kw - 1) // upx + 2
    in_h = ((th - 1) * downy + kh - 1) // upy + 2
    if separable:
        assert f is not None and f.ndim == 1 and dtype != torch.bfloat16
        a = f.numpy().astype(np.float32)
        a = a if flip else a[::-1]
        wx, wy = np.zeros(kw), np.zeros(kh)
        wx[sx:sx + fw], wy[sy:sy + fh] = a, a * np.float32(gain)
    else:
        taps = _kernel_taps(f, gain, flip, sx, sy, kw, kh, dtype)

    def phase(o, o0, up, down):
        k0 = (up - (o * down) % up) % up
        return k0, (o * down + k0) // up - (o0 * down) // up

    for oy_t in range(0, out_h, th):
        for ox_t in range(0, out_w, tw):
            xs = _smem_tile(x, oy_t * downy // upy - p0y, ox_t * downx // upx - p0x, in_h, in_w)
            if separable:
                ts = np.zeros((in_h, tw))
                for col in range(tw):
                    k0, i0 = phase(ox_t + col, ox_t, upx, downx)
                    assert i0 + kw // upx <= in_w
                    ts[:, col] = xs[:, i0:i0 + kw // upx] @ wx[k0::upx]
            for oy in range(oy_t, min(oy_t + th, out_h)):
                ky0, iy0 = phase(oy, oy_t, upy, downy)
                assert iy0 + kh // upy <= in_h
                for ox in range(ox_t, min(ox_t + tw, out_w)):
                    if separable:
                        y[oy, ox] = ts[iy0:iy0 + kh // upy, ox - ox_t] @ wy[ky0::upy]
                        continue
                    kx0, ix0 = phase(ox, ox_t, upx, downx)
                    assert ix0 + kw // upx <= in_w
                    y[oy, ox] = np.sum(xs[iy0:iy0 + kh // upy, ix0:ix0 + kw // upx]
                                       * taps[ky0::upy, kx0::upx])
    return y


def _form_of(f, up, down, pad):
    """The form csrc's `launch` picks for a float32 x."""
    (upx, upy), (downx, downy) = up, down
    fh, fw = (1, 1) if f is None else (f.shape[0], f.shape[-1])
    kw, kh = _shift(pad[0], upx, fw)[2], _shift(pad[2], upy, fh)[2]
    if upx == upy and downx == downy and kw == kh == 4:
        for u, d, mx, my, bx, by in _tiled_forms():
            if (u, d) == (upx, downx):
                return ("tiled", u, d, mx, my, bx, by)
    return ("separable",) if f is not None and f.ndim == 1 else ("generic",)


def test_tiled_forms_read_from_the_source():
    assert sorted(_tiled_forms()) == [(1, 1, 4, 4, 16, 16), (1, 2, 4, 2, 16, 16),
                                      (2, 1, 8, 4, 16, 16)]


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_algorithm_matches_plain(case):
    """Each case in the form the kernel picks, on planes a little larger
    than one tile (partial edge tiles), and in the run-time form too, summed
    in float64: the same taps as the plain version to 1e-12 of the largest
    entry; the separable form's taps are products of float32 1-D taps, not
    float32 roundings of the 2-D products, so to 1e-6."""
    f, up, down, pad, flip, gain = _args(case, flip=len(case) % 2 == 1)
    forms = {_form_of(f, up, down, pad), ("generic",)}
    # 66 x 129: thin ragged edges (a few outputs past whole tiles) on the
    # main path's cases.
    for shape in ((37, 70), (66, 129)):
        x = _x((1, 1) + shape, torch.float64, seed=8)
        want = upfirdn2d_plain(x, f, up, down, pad, flip, gain)[0, 0].numpy()
        for form in forms:
            got = _emulate(x[0, 0].numpy(), f, up, down, pad, flip, gain, form)
            tol = 1e-6 if form[0] == "separable" else 1e-12
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                                       err_msg=f"{form} {shape}")


def test_kernel_taps_are_the_plain_versions():
    """load_taps' folding and rounding give the plain version's weights
    bitwise: f * gain in float32 (1-D: outer product first), flipped unless
    flip_filter, cast to x's dtype."""
    for case in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for flip in (False, True):
                f, up, down, pad, _, gain = _args(case, flip, dtype=torch.float32)
                fw = torch.ones(1, 1) if f is None else f
                fw = torch.outer(fw, fw) if fw.ndim == 1 else fw
                fw = fw * gain
                want = (fw if flip else fw.flip([0, 1])).to(dtype).double().numpy()
                got = _kernel_taps(f, gain, flip, 0, 0, want.shape[1], want.shape[0], dtype)
                np.testing.assert_array_equal(got, want, err_msg=f"{case} {dtype} {flip}")
