"""The fused filtered_lrelu kernel's algorithm, its plain versions and its
autograd Function, on the CPU.

- The plain versions (`filtered_lrelu_fwd_plain`: the forward with packed
  signs; `filtered_lrelu_bwd_plain`: dx and db from the signs alone) equal
  autograd through the composition in float64, on every StyleGAN3-T
  FFHQ-1024 layer of `benchmark/reference/stylegan3.schedule` (up 1 / 2 /
  4, down 1 / 2, 12- and 24-tap filters, the identity ToRGB layer), with
  ties at 0 and at +-clamp, where the composition's derivative follows the
  bias_act kernel's (lrelu'(0) = 1, 0 where clamped); and, in float32, the
  composition as `filtered_lrelu_composed` runs it on the CPU.
- `pack_signs` at ragged widths, bit by bit.
- The kernel's tiling restated in numpy (csrc/filtered_lrelu.cu): tile
  extents, the phase-0 start of each region, halos, the strips' reads
  inside shared memory, each output and each sign byte written by exactly
  one tile, the block partial sums of db, with the constants read from the
  source; against the plain versions.
- `_FilteredLReLUCuda` on kernels emulated by the plain versions: the
  gradients, signs written only where a gradient is needed, nothing but
  the signs and filters saved, a second derivative refused.
- The CUDA wrapper refuses what the kernel does not take, and the router
  sends 2-D filters, other dtypes and other factors to the composition.
- Every `__global__` kernel of the source counts for `fir_ms_per_step` and
  not for `conv_ms_per_step`.
"""

import importlib
import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import stylegan3 as ref
from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops.upfirdn2d import upfirdn2d_plain
from torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# The module (the package exports the function under the same name).
FL = importlib.import_module("spi_tpu_torch.ops.filtered_lrelu")
SOURCE = (ROOT / "spi_tpu_torch" / "csrc" / "filtered_lrelu.cu").read_text()
SG3T = json.loads((ROOT / "benchmark" / "configs" / "stylegan3_t_ffhq1024_clip_edit.json")
                  .read_text())["generator"]
LAYERS = ref.schedule(SG3T)[0]
CLAMP = float(SG3T["conv_clamp"])


def _layer(L):
    """(fu, fd, up, down, padding (x0, x1, y0, y1), gain, slope) of a
    schedule layer, float64 filters."""
    fu, fd = (None if f is None else torch.tensor(f, dtype=torch.float64)
              for f in (L["up_filter"], L["down_filter"]))
    pad = (L["padding"][0], L["padding"][1], L["padding"][0], L["padding"][1])
    return (fu, fd, L["up"], L["down"], pad, 1.0 if L["torgb"] else math.sqrt(2.0),
            1.0 if L["torgb"] else 0.2)


def _in_size(L, out):
    """The least input side whose output has at least `out` values."""
    fu, fd, up, down, pad = _layer(L)[:5]
    h = 1
    while FL._sizes(h, h, FL.filter_size(fu), FL.filter_size(fd), up, down, pad)[2] < out:
        h += 1
    return h


def _rand(shape, seed, dtype=torch.float64, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).mul(scale).to(dtype)


def composition64(x, fu, fd, b, up, down, pad, gain, slope, clamp, flip):
    """The composition's function with the derivative of the card's
    kernels (bias_act's lrelu'(0) = 1, 0 where not |v| < clamp), in the
    dtype of x, differentiable by autograd."""
    u = upfirdn2d_plain(x + b[None, :, None, None], fu, up=up, padding=pad, gain=up**2,
                        flip_filter=flip)
    v = torch.where(u >= 0, u, u * slope) * gain
    if clamp is not None:
        v = torch.where(v.abs() < clamp, v, v.detach().clamp(-clamp, clamp))
    return upfirdn2d_plain(v, fd, down=down, flip_filter=flip)


def _check_plain_against_autograd(x, fu, fd, b, up, down, pad, gain, slope, clamp, flip, seed):
    x, b = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = composition64(x, fu, fd, b, up, down, pad, gain, slope, clamp, flip)
    dy = _rand(want.shape, seed)
    want_dx, want_db = torch.autograd.grad(want, (x, b), dy)
    y, signs = FL.filtered_lrelu_fwd_plain(x.detach(), fu, fd, b.detach(), up, down, pad, gain,
                                           slope, clamp, flip)
    dx, db = FL.filtered_lrelu_bwd_plain(dy, signs, fu, fd, tuple(x.shape[2:]), up, down, pad,
                                         gain, slope, flip)
    for got, ref_ in ((y, want), (dx, want_dx), (db, want_db)):
        torch.testing.assert_close(got, ref_.detach(), rtol=0,
                                   atol=1e-12 * max(1.0, float(ref_.detach().abs().max())))
    return signs


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("layer", range(len(LAYERS)), ids=[L["name"] for L in LAYERS])
def test_plain_equals_autograd_of_the_composition(layer, flip):
    """Each layer's filters, factors and padding at a small size (an input
    whose output is 11 values a side at least), a random bias, inputs
    scaled so that some values clamp."""
    L = LAYERS[layer]
    fu, fd, up, down, pad, gain, slope = _layer(L)
    h = _in_size(L, 11)
    x = _rand((2, 3, h, h + 3), seed=layer, scale=300.0)
    b = _rand((3,), seed=100 + layer)
    signs = _check_plain_against_autograd(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, flip,
                                          seed=200 + layer)
    neg, clamped = FL.unpack_signs(signs, FL._sizes(h, h + 3, FL.filter_size(fu),
                                                    FL.filter_size(fd), up, down, pad)[1])
    assert neg.any() and (~neg).any() and clamped.any() and (~clamped).any()


@pytest.mark.parametrize("layer", [0, 2, 13, 14], ids=lambda i: LAYERS[i]["name"])
def test_plain_ties_at_zero_and_clamp(layer):
    """Values of u exactly 0 and exactly +-clamp: a one-hot up filter makes
    u up^2 (x + b) at the input's samples and 0 between them, so x + b in
    {0, +-clamp / (gain up^2)} (slope 1 at ToRGB) lands on the ties."""
    L = LAYERS[layer]
    fu, fd, up, down, pad, gain, slope = _layer(L)
    if fu is not None:
        fu = torch.zeros_like(fu)
        fu[len(fu) // 2] = 1.0
    h = _in_size(L, 9)
    b = torch.tensor([0.5, -0.25, 0.0], dtype=torch.float64)
    levels = torch.tensor([0.0, CLAMP / (gain * up * up), -CLAMP / (slope * gain * up * up), 1.0,
                           -1.0], dtype=torch.float64)
    pick = torch.randint(0, len(levels), (2, 3, h, h + 1),
                         generator=torch.Generator().manual_seed(9))
    x = levels[pick] - b[None, :, None, None]
    signs = _check_plain_against_autograd(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, False,
                                          seed=300 + layer)
    xb = (x + b[None, :, None, None])
    u = upfirdn2d_plain(xb, fu, up=up, padding=pad, gain=up**2)
    neg, clamped = FL.unpack_signs(signs, u.shape[-1])
    assert (u == 0).any() and not neg[u == 0].any()
    v = torch.where(u >= 0, u, u * slope) * gain
    assert (v == CLAMP).any() and (v == -CLAMP).any()
    assert clamped[v.abs() == CLAMP].all()


@pytest.mark.parametrize("layer", [0, 2, 10, 14], ids=lambda i: LAYERS[i]["name"])
def test_plain_equals_the_float32_composition(layer):
    """In float32, against `filtered_lrelu_composed` as the CPU runs it
    (bias_act and upfirdn2d's plain versions) with autograd: the same
    values to float32 rounding."""
    L = LAYERS[layer]
    fu, fd, up, down, pad, gain, slope = _layer(L)
    fu, fd = (None if f is None else f.float() for f in (fu, fd))
    h = _in_size(L, 12)
    x = _rand((2, 3, h, h), seed=layer, dtype=torch.float32, scale=100.0).requires_grad_(True)
    b = _rand((3,), seed=50 + layer, dtype=torch.float32).requires_grad_(True)
    want = FL.filtered_lrelu_composed(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, False)
    dy = _rand(want.shape, seed=60 + layer, dtype=torch.float32)
    want_dx, want_db = torch.autograd.grad(want, (x, b), dy)
    y, signs = FL.filtered_lrelu_fwd_plain(x.detach(), fu, fd, b.detach(), up, down, pad, gain,
                                           slope, CLAMP, False)
    dx, db = FL.filtered_lrelu_bwd_plain(dy, signs, fu, fd, (h, h), up, down, pad, gain, slope,
                                         False)
    for got, ref_ in ((y, want), (dx, want_dx), (db, want_db)):
        torch.testing.assert_close(got, ref_.detach(), rtol=0,
                                   atol=2e-6 * float(ref_.detach().abs().max()))


@pytest.mark.parametrize("w", range(1, 10))
def test_sign_packing_at_ragged_widths(w):
    g = torch.Generator().manual_seed(w)
    neg = torch.rand(2, 3, 5, w, generator=g) < 0.5
    clamped = torch.rand(2, 3, 5, w, generator=g) < 0.3
    s = FL.pack_signs(neg, clamped)
    assert s.dtype == torch.uint8 and tuple(s.shape) == (2, 3, 5, (w + 3) // 4)
    n, c = neg.numpy(), clamped.numpy()
    want = np.zeros(s.shape, np.uint8)
    for q in range(w):
        want[..., q // 4] |= ((n[..., q] * 1 + c[..., q] * 2) << (2 * (q % 4))).astype(np.uint8)
    np.testing.assert_array_equal(s.numpy(), want)
    a, b = FL.unpack_signs(s, w)
    assert torch.equal(a, neg) and torch.equal(b, clamped)


# --- The kernel's algorithm, restated -------------------------------------


def _constant(name):
    m = re.search(rf"\b{name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


THREADS, STRIP, OUT_TILE = _constant("kThreads"), _constant("kStrip"), _constant("kOutTile")


def _bwd_tile(up):
    """Bwd<U, D>::T and ::M4 as the source writes them."""
    t = re.search(r"static constexpr int T = U == (\d+) \? (\d+) : (\d+);", SOURCE)
    m4 = re.search(r"static constexpr int M4 = T == (\d+) \? (\d+) : (\d+);", SOURCE)
    assert t and m4
    tile = int(t.group(2)) if up == int(t.group(1)) else int(t.group(3))
    return tile, int(m4.group(2)) if tile == int(m4.group(1)) else int(m4.group(3))


def _round_up(n, m):
    return (n + m - 1) // m * m


def _taps(f, n, reverse, scale):
    """csrc tap(): f reversed where `reverse`, times scale; no filter: [scale].
    The taps are float32, as the kernel's and the plain version's."""
    if f is None:
        return np.array([scale])
    f = f.numpy().astype(np.float32).astype(np.float64)
    return (f[::-1] if reverse else f) * scale


def _pass(src, axis, up, down, k, m, lines, strips, off, w):
    """fir_pass: `lines` lines of src along `axis` (1: x), strips * m
    outputs a line; output o sums w[k] src[(o * down + k) / up + off] over
    k with up dividing o * down + k, strip by strip as the threads read it.
    Asserts every read lies in src."""
    assert m % up == 0
    nin = ((m - 1) * down + k - 1) // up + 1
    src = src if axis == 1 else src.T
    out = np.zeros((lines, strips * m))
    for s in range(strips):
        o0 = s * m
        base = o0 * down // up + off
        assert base >= 0 and base + nin <= src.shape[1] and lines <= src.shape[0]
        for t in range(nin):
            v = src[:lines, base + t]
            for j in range(m):
                kk = t * up - j * down
                if 0 <= kk < k:
                    out[:, o0 + j] += v * w[kk]
    return out if axis == 1 else out.T


def _tile_load(x, r0, c0, rows, cols, add):
    h, w = x.shape
    out = np.zeros((rows, cols))
    ys, xs = np.arange(r0, r0 + rows), np.arange(c0, c0 + cols)
    vy, vx = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
    out[np.ix_(vy, vx)] = x[np.ix_(ys[vy], xs[vx])] + add
    return out


def _fwd_shapes(up, down):
    ku, kd = FL.UP_TAPS[up], FL.DOWN_TAPS[down]
    nq = _round_up(up - 1 + OUT_TILE * down + kd - 1, STRIP)
    return ku, kd, nq, (nq - 1 + ku - 1) // up + 1


def emulate_fwd(x, fu, fd, b, up, down, pad, gain, slope, clamp, flip):
    """filtered_lrelu_fwd_kernel on (N, C, H, W) float64: (y, signs), each
    output and each sign byte asserted written once."""
    n, c, h, w = x.shape
    px0, _, py0, _ = pad
    up_h, up_w, out_h, out_w = FL._sizes(h, w, FL.filter_size(fu), FL.filter_size(fd), up, down,
                                         pad)
    ku, kd, nq, ni = _fwd_shapes(up, down)
    t = OUT_TILE
    tiles_y, tiles_x = -(-out_h // t), -(-out_w // t)
    sw = (up_w + 3) // 4
    wu, wd = _taps(fu, ku, not flip, float(up)), _taps(fd, kd, not flip, 1.0)
    y = np.zeros((n, c, out_h, out_w))
    signs = np.zeros((n, c, up_h, sw), np.uint8)
    y_writes = np.zeros(y.shape, int)
    s_writes = np.zeros(signs.shape, int)
    for plane in range(n * c):
        xp = x[plane // c, plane % c].numpy()
        bias = 0.0 if b is None else float(b[plane % c])
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                ox0, oy0 = tx * t, ty * t
                ex, ey = (ox0 * down - px0) % up, (oy0 * down - py0) % up
                qx0, qy0 = ox0 * down - ex, oy0 * down - ey
                assert (qx0 - px0) % up == 0 and (qy0 - py0) % up == 0
                xs = _tile_load(xp, (qy0 - py0) // up, (qx0 - px0) // up, ni, ni, bias)
                hs = _pass(xs, 1, up, 1, ku, STRIP, ni, nq // STRIP, 0, wu)
                u = _pass(hs, 0, up, 1, ku, STRIP, nq, nq // STRIP, 0, wu)
                neg = ~(u >= 0)
                v = np.where(neg, u * slope, u) * gain
                clamped = ~(np.abs(v) < clamp) if clamp is not None else np.zeros_like(neg)
                if clamp is not None:
                    v = np.clip(v, -clamp, clamp)
                code = neg * 1 + clamped * 2
                # The owned rows and byte columns.
                g0, r0 = ox0 * down // 4, oy0 * down
                g1 = sw if tx == tiles_x - 1 else (ox0 + t) * down // 4
                r1 = up_h if ty == tiles_y - 1 else (oy0 + t) * down
                assert t * down % 4 == 0
                for qy in range(r0, r1):
                    for g in range(g0, g1):
                        bits = 0
                        for j in range(4):
                            if 4 * g + j < up_w:
                                lr, lc = qy - qy0, 4 * g + j - qx0
                                assert 0 <= lr < nq and 0 <= lc < nq
                                bits |= int(code[lr, lc]) << (2 * j)
                        signs[plane // c, plane % c, qy, g] = bits
                        s_writes[plane // c, plane % c, qy, g] += 1
                d1 = _pass(v, 1, 1, down, kd, STRIP, nq, t // STRIP, ex, wd)
                out = _pass(d1, 0, 1, down, kd, 4, t, t // 4, ey, wd)
                rows, cols = min(t, out_h - oy0), min(t, out_w - ox0)
                y[plane // c, plane % c, oy0:oy0 + rows, ox0:ox0 + cols] = out[:rows, :cols]
                y_writes[plane // c, plane % c, oy0:oy0 + rows, ox0:ox0 + cols] += 1
    assert (y_writes == 1).all() and (s_writes == 1).all()
    return torch.from_numpy(y), torch.from_numpy(signs)


def emulate_bwd(dy, signs, fu, fd, in_hw, up, down, pad, gain, slope, flip):
    """filtered_lrelu_bwd_kernel and filtered_lrelu_bias_grad_kernel on
    float64: (dx, db), each dx value asserted written once; db summed from
    the blocks' partial sums."""
    n, c, out_h, out_w = dy.shape
    h, w = in_hw
    px0, _, py0, _ = pad
    up_h, up_w, _, _ = FL._sizes(h, w, FL.filter_size(fu), FL.filter_size(fd), up, down, pad)
    ku, kd = FL.UP_TAPS[up], FL.DOWN_TAPS[down]
    t, m4 = _bwd_tile(up)
    nq = _round_up(down - 1 + (t - 1) * up + ku, STRIP)
    no = (nq - 1 + kd - 1) // down + 1
    tiles_y, tiles_x = -(-h // t), -(-w // t)
    w2, w4 = _taps(fd, kd, flip, 1.0), _taps(fu, ku, flip, float(up))
    sbytes, sw = signs.numpy(), signs.shape[-1]
    dx = np.zeros((n, c, h, w))
    writes = np.zeros(dx.shape, int)
    part = np.zeros((n, c, tiles_y * tiles_x))
    for plane in range(n * c):
        k, ch = plane // c, plane % c
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                ix0, iy0 = tx * t, ty * t
                bx, by = ix0 * up + px0 - (ku - 1), iy0 * up + py0 - (ku - 1)
                ex, ey = (bx - (kd - 1)) % down, (by - (kd - 1)) % down
                qx0, qy0 = bx - ex, by - ey
                assert (qx0 - (kd - 1)) % down == 0
                ys = _tile_load(dy[k, ch].numpy(), (qy0 - (kd - 1)) // down,
                                (qx0 - (kd - 1)) // down, no, no, 0.0)
                gs = _pass(ys, 1, down, 1, kd, STRIP, no, nq // STRIP, 0, w2)
                dv = _pass(gs, 0, down, 1, kd, STRIP, nq, nq // STRIP, 0, w2)
                # The region's sign bytes from byte column floor(qx0 / 4), NG a
                # row; a byte outside the map reads 0xaa (every value clamped).
                g0, n_g = qx0 // 4, nq // 4 + 1
                ss = np.full((nq, n_g), 0xaa, np.uint8)
                for r in range(nq):
                    for g in range(n_g):
                        if 0 <= qy0 + r < up_h and 0 <= g0 + g < sw:
                            ss[r, g] = sbytes[k, ch, qy0 + r, g0 + g]
                qx = np.arange(qx0, qx0 + nq)
                assert (qx // 4 - g0 >= 0).all() and (qx // 4 - g0 < n_g).all()
                code = (ss[:, qx // 4 - g0] >> (2 * (qx % 4))) & 3
                du = np.where(code & 2, 0.0, np.where(code & 1, dv * slope, dv) * gain)
                e = _pass(du, 1, 1, up, ku, STRIP, nq, t // STRIP, ex, w4)
                out = _pass(e, 0, 1, up, ku, m4, t, t // m4, ey, w4)
                rows, cols = min(t, h - iy0), min(t, w - ix0)
                dx[k, ch, iy0:iy0 + rows, ix0:ix0 + cols] = out[:rows, :cols]
                writes[k, ch, iy0:iy0 + rows, ix0:ix0 + cols] += 1
                part[k, ch, ty * tiles_x + tx] = out[:rows, :cols].sum()
    assert (writes == 1).all()
    return torch.from_numpy(dx), torch.from_numpy(part.sum(axis=(0, 2)))


@pytest.mark.parametrize("layer", [0, 2, 9, 10, 11, 13, 14], ids=lambda i: LAYERS[i]["name"])
def test_kernel_algorithm_matches_plain(layer):
    """Planes of a tile and a ragged part (outputs 1-2 tiles a side, an
    input of 1-3 backward tiles), flip on odd layers: the emulated kernels
    against the plain versions, the signs bitwise, the rest summed in
    float64 to 1e-7 of the largest entry: the kernels' taps are products of
    float32 1-D taps, the plain version's float32 roundings of the 2-D
    products (upfirdn2d_plain's outer product)."""
    L = LAYERS[layer]
    fu, fd, up, down, pad, gain, slope = _layer(L)
    flip = layer % 2 == 1
    h = _in_size(L, OUT_TILE + 5)
    x = _rand((1, 2, h, h + 7), seed=layer, scale=300.0)
    b = _rand((2,), seed=10 + layer)
    y, signs = FL.filtered_lrelu_fwd_plain(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, flip)
    got_y, got_signs = emulate_fwd(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, flip)
    assert torch.equal(got_signs, signs)
    torch.testing.assert_close(got_y, y, rtol=0, atol=1e-7 * float(y.abs().max()))
    dy = _rand(y.shape, seed=20 + layer)
    dx, db = FL.filtered_lrelu_bwd_plain(dy, signs, fu, fd, (h, h + 7), up, down, pad, gain, slope,
                                         flip)
    got_dx, got_db = emulate_bwd(dy, signs, fu, fd, (h, h + 7), up, down, pad, gain, slope, flip)
    torch.testing.assert_close(got_dx, dx, rtol=0, atol=1e-7 * float(dx.abs().max()))
    torch.testing.assert_close(got_db, db, rtol=0,
                               atol=1e-7 * float(dx.abs().sum(dim=(0, 2, 3)).max()))


@pytest.mark.parametrize("up,down", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2)])
def test_every_form_fits_shared_memory(up, down):
    """Each compile-time form's shared memory (Fwd / Bwd::kSmem restated)
    fits an H100 block's 227 KB, and the halo's recomputed work is under
    half of a tile's."""
    ku, kd, nq, ni = _fwd_shapes(up, down)
    r0 = max(ni * (ni | 1), nq * nq // 4)
    r1 = max(ni * (nq | 1), nq * (OUT_TILE | 1))
    fwd = 4 * (r0 + r1 + nq * (nq | 1) + ku + kd)
    t, _ = _bwd_tile(up)
    bq = _round_up(down - 1 + (t - 1) * up + ku, STRIP)
    no = (bq - 1 + kd - 1) // down + 1
    bwd = 4 * (max(no * (no | 1), bq * (t | 1)) + no * (bq | 1) + bq * (bq | 1) + ku + kd
               + THREADS // 32)
    assert fwd <= 232_448 and bwd <= 232_448
    if up > 1 and down > 1:
        # Multiply-adds of a tile's four passes against the least for its
        # outputs (each separable filter's real taps, as benchmark/counts).
        real_up = ku // up
        work = ni * nq * real_up + nq * nq * real_up + nq * OUT_TILE * kd + OUT_TILE**2 * kd
        hu = OUT_TILE * down
        least = (hu // up * hu + hu * hu) * real_up + (hu * OUT_TILE + OUT_TILE**2) * kd
        assert work < 1.5 * least, (work, least)


# --- The autograd Function on emulated kernels ----------------------------


@pytest.fixture
def emulated(monkeypatch):
    """The two CUDA wrappers on the CPU, from the plain versions; each
    call recorded."""
    calls = []

    def fwd(x, fu, fd, b, up, down, pad, gain, slope, clamp, flip, write_signs):
        calls.append(("fwd", write_signs))
        y, signs = FL.filtered_lrelu_fwd_plain(x, fu, fd, b, up, down, pad, gain, slope, clamp,
                                               flip)
        return y, signs if write_signs else None

    def bwd(dy, signs, fu, fd, in_hw, up, down, pad, gain, slope, flip, need_db):
        calls.append(("bwd", need_db))
        return FL.filtered_lrelu_bwd_plain(dy, signs, fu, fd, in_hw, up, down, pad, gain, slope,
                                           flip, need_db)

    monkeypatch.setattr(FL, "filtered_lrelu_fwd_cuda", fwd)
    monkeypatch.setattr(FL, "filtered_lrelu_bwd_cuda", bwd)
    return calls


def _apply(x, fu, fd, b, up, down, pad, gain, slope, write):
    return FL._FilteredLReLUCuda.apply(x, fu, fd, b, up, down, pad, gain, slope, CLAMP, False,
                                       write)


@pytest.mark.parametrize("layer", [1, 10, 14], ids=lambda i: LAYERS[i]["name"])
def test_function_gradients_emulated(emulated, layer):
    fu, fd, up, down, pad, gain, slope = _layer(LAYERS[layer])
    h = _in_size(LAYERS[layer], 10)
    x = _rand((2, 3, h, h), seed=layer, scale=300.0).requires_grad_(True)
    b = _rand((3,), seed=1).requires_grad_(True)
    y = _apply(x, fu, fd, b, up, down, pad, gain, slope, True)
    # Only the signs and the filters are saved.
    saved = [t for t in y.grad_fn.saved_tensors if t is not None]
    assert [t.dtype for t in saved] == [torch.uint8] + [torch.float64] * (len(saved) - 1)
    assert not any(t.shape == x.shape for t in saved)
    dy = _rand(y.shape, seed=2)
    got = torch.autograd.grad(y, (x, b), dy)
    want = torch.autograd.grad(composition64(x, fu, fd, b, up, down, pad, gain, slope, CLAMP,
                                             False), (x, b), dy)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=0, atol=1e-12 * float(w_.abs().max()))
    assert emulated == [("fwd", True), ("bwd", True)]


def test_function_second_derivative_raises(emulated):
    fu, fd, up, down, pad, gain, slope = _layer(LAYERS[0])
    x = _rand((1, 2, 12, 12), seed=3).requires_grad_(True)
    y = _apply(x, fu, fd, None, up, down, pad, gain, slope, True)
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(dx.sum(), x)


def test_router_writes_signs_only_for_a_gradient(emulated, monkeypatch):
    """`filtered_lrelu`'s fused route on tensors the router takes as CUDA
    ones: signs under grad mode where x or b requires grad, and not under
    no_grad or for constant inputs (the frozen twin, samples, videos)."""
    fu, fd, up, down, pad, gain, slope = _layer(LAYERS[3])
    fu, fd = fu.float(), fd.float()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    x = _rand((1, 2, 10, 10), seed=4, dtype=torch.float32)
    b = torch.zeros(2)
    kw = dict(fu=fu, fd=fd, up=up, down=down, padding=pad, gain=gain, slope=slope, clamp=CLAMP)
    FL.filtered_lrelu(x, b=b, **kw)
    with torch.no_grad():
        FL.filtered_lrelu(x.requires_grad_(True), b=b, **kw)
    FL.filtered_lrelu(x, b=b, **kw)
    FL.filtered_lrelu(x.detach(), b=b.requires_grad_(True), **kw).sum().backward()
    assert emulated == [("fwd", False), ("fwd", False), ("fwd", True), ("fwd", True),
                        ("bwd", True)]


# --- Routing and refusals --------------------------------------------------


def test_router_takes_every_sg3t_layer_and_refuses_the_rest():
    for L in LAYERS:
        fu, fd, up, down = (_layer(L)[i] for i in range(4))
        fu, fd = (None if f is None else f.float() for f in (fu, fd))
        x = torch.zeros(1, L["cout"], 4, 4)
        assert FL.fused_refusal(x, fu, fd, torch.zeros(L["cout"]), up, down) is None, L["name"]
    f12 = torch.ones(12) / 12
    x = torch.zeros(1, 3, 8, 8)
    for args, match in (
            ((x, f12, torch.outer(f12, f12), None, 2, 2), "1-D float32 filters"),
            ((x, torch.outer(f12, f12), f12, None, 2, 2), "1-D float32 filters"),
            ((x.double(), f12, f12, None, 2, 2), "float32 NCHW"),
            ((x.bfloat16(), f12, f12, None, 2, 2), "float32 NCHW"),
            ((x[0], f12, f12, None, 2, 2), "float32 NCHW"),
            ((x, f12.double(), f12, None, 2, 2), "1-D float32 filters"),
            ((x, torch.ones(18) / 18, f12, None, 3, 2), "up factor and taps"),
            ((x, torch.ones(13) / 13, f12, None, 2, 2), "up factor and taps"),
            ((x, f12, torch.ones(24) / 24, None, 2, 4), "down factor and taps"),
            ((x, None, f12, None, 2, 2), "up factor and taps"),
            ((x, f12, f12, torch.zeros(4), 2, 2), r"\(C,\) bias"),
            ((x, f12, f12, torch.zeros(3).double(), 2, 2), r"\(C,\) bias")):
        assert re.search(match, FL.fused_refusal(*args) or ""), (args[1:], match)


def test_cuda_wrapper_rejects(no_library_fl):
    f12 = torch.ones(12) / 12
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError, match="1-D float32 filters"):
        FL.filtered_lrelu_fwd_cuda(x, f12, torch.outer(f12, f12), None, 2, 2, (9, 8, 9, 8),
                                   1.0, 0.2, None, False, True)
    with pytest.raises(ValueError, match="float32 NCHW"):
        FL.filtered_lrelu_fwd_cuda(x.double(), f12, f12, None, 2, 2, (9, 8, 9, 8), 1.0, 0.2,
                                   None, False, True)
    with pytest.raises(ValueError, match="smaller than filter"):
        FL.filtered_lrelu_fwd_cuda(x, f12, f12, None, 2, 2, (-12, -12, 0, 0), 1.0, 0.2, None,
                                   False, True)
    with pytest.raises(ValueError, match="CUDA"):
        FL.filtered_lrelu_fwd_cuda(x, f12, f12, None, 2, 2, (9, 8, 9, 8), 1.0, 0.2, None, False,
                                   True)
    with pytest.raises(ValueError, match="do not fit"):
        FL.filtered_lrelu_bwd_cuda(torch.zeros(1, 3, 8, 8), torch.zeros(1, 3, 4, 4,
                                                                        dtype=torch.uint8),
                                   f12, f12, (8, 8), 2, 2, (9, 8, 9, 8), 1.0, 0.2, False, True)


@pytest.fixture
def no_library_fl(monkeypatch):
    """Fails a test that reaches the kernel library; launch counts at 0."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_lib, "lib", refuse)
    _lib.reset_launch_counts()
    yield
    assert not any(_lib.launch_counts.values()), _lib.launch_counts


@pytest.mark.parametrize("radial", [False, True])
def test_cpu_takes_the_composition(no_library_fl, radial):
    """A CPU tensor, 1-D or 2-D filters: `filtered_lrelu_composed` bitwise,
    no kernel library, no launch."""
    fu, fd, up, down, pad, gain, slope = _layer(LAYERS[2])
    fu, fd = fu.float(), fd.float()
    if radial:
        fd = torch.outer(fd, fd)
    x = _rand((1, 2, 14, 14), seed=5, dtype=torch.float32)
    b = _rand((2,), seed=6, dtype=torch.float32)
    got = FL.filtered_lrelu(x, fu, fd, b, up, down, pad, gain, slope, CLAMP)
    assert torch.equal(got, FL.filtered_lrelu_composed(x, fu, fd, b, up, down, pad, gain, slope,
                                                       CLAMP, False))


def test_kernel_names_count_for_the_fir_metric_not_the_convolutions():
    metrics = {}
    for name in ("conv_ms_per_step", "fir_ms_per_step"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "benchmark" / "metrics" / f"{name}.py")
        metrics[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(metrics[name])
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", SOURCE)
    assert sorted(names) == ["filtered_lrelu_bias_grad_kernel", "filtered_lrelu_bwd_kernel",
                             "filtered_lrelu_fwd_kernel"], names
    seen = []

    class Slice:
        steps = 1

        @staticmethod
        def kernel_s(pred):
            seen.append(pred(symbol))
            return 1.0, 1

    class M:
        slice = Slice
        cell = type("Cell", (), {"filtered_lrelu_calls": None})

    for name in names:
        # As a profiler names a template instance.
        symbol = f"void (anonymous namespace)::{name}<2, 2>((anonymous namespace)::Params)"
        assert not metrics["conv_ms_per_step"].is_conv(symbol)
        seen.clear()
        metrics["fir_ms_per_step"].read(M)
        assert seen == [True]
