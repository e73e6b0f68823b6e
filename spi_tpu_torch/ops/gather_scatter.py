"""Row gather and row scatter-add (counterparts of the Pallas probes
`gather_kernel` in tools/profile_gather.py and the serial RMW `kernel` in
tools/probe_scatter_r5.py).

- `row_gather(tab, idx)`: out[i, j] = tab[idx[i, j], j] for a (R, C)
  float32 table and (P, C) int32 indices, any P: `jnp.take_along_axis` on
  axis 0 in its default mode, so an index in [-R, 0) wraps to idx + R
  and any other index outside [0, R) gives NaN.
- `row_scatter_add(rows, upd, n_out)`: zeros(n_out, C).at[rows].add(upd)
  for (P,) or (P, 1) int32 rows and (P, C) float32 updates: as JAX's
  scatter, a row in [-n_out, 0) wraps to row + n_out and every other row
  outside [0, n_out) is dropped.

On a CUDA tensor each launches its kernel (`csrc/row_gather.cu`,
`csrc/row_scatter_add.cu`); on a CPU tensor it runs the plain version
(`torch.gather`, `index_add_`). The scatter-add kernel has two routes
(`scatter_route`): updates binned by table slice, each slice's rows
summed in registers and written once (`row_scatter_add_binned` restates
it in plain PyTorch), and, for rows of at most ATOMIC_MAX_C channels into
a table that fits half the L2, one float4 reduction an update row and
channel group into the zeroed table.
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops import _lib

# The scatter-add kernel's constants (csrc/row_scatter_add.cu).
SLICE_ROWS = 64      # table rows one bucket covers (kSliceRows)
BUCKET_SPLIT = 4096  # most entries one block of the sum pass takes (kBucketSplit)
RUN_SPLIT = 64       # longest run of one row that one lane group sums alone (kRunSplit)
CHUNK = 8192         # updates one block of the count and place passes takes (kChunk)
MAX_BUCKETS = 16384  # buckets a block's histogram holds (kMaxBuckets)
MAX_ROWS = SLICE_ROWS * MAX_BUCKETS
# Widest rows the atomic route takes: one 128-byte line. The binned route
# gathers each update row at random, which reaches a lower share of the
# memory's rate for rows this short, while the atomic route streams the
# updates and adds into a table that stays in the L2 (chip_smoke.py
# phase 2 times both routes at each shape).
ATOMIC_MAX_C = 32


def scatter_route(c: int, n_out: int, l2_bytes: int) -> str:
    """'atomic' for rows of at most ATOMIC_MAX_C channels into a table of
    at most half the L2 (`l2_bytes`), else 'binned'."""
    return "atomic" if c <= ATOMIC_MAX_C and n_out * c * 4 <= l2_bytes // 2 else "binned"


def _wrap(r, n: int):
    """int64 row ids with [-n, 0) wrapped to [0, n), and which are in range."""
    r = torch.where(r < 0, r + n, r)
    return r, (r >= 0) & (r < n)


def _check_gather(tab, idx):
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"table {tuple(tab.shape)} and indices {tuple(idx.shape)} do not match")


def row_gather_plain(tab, idx):
    """The plain PyTorch version: `torch.gather` on axis 0 at the wrapped
    indices, NaN where an index is out of range."""
    _check_gather(tab, idx)
    r, live = _wrap(idx.long(), tab.shape[0])
    out = torch.gather(tab, 0, torch.where(live, r, 0))
    return torch.where(live, out, torch.nan)


def row_gather_cuda(tab, idx):
    """Launch the gather kernel: same function as `row_gather_plain`,
    bitwise. C must be a multiple of 4.

    The host work is kept short, since at the probe's 25 MB the kernel's
    device time is a few microseconds: one combined test of the inputs
    (the reasons are sorted out only when it fails), the raw stream
    handle, one allocation and one ctypes call.
    """
    if not (tab.is_cuda and tab.dtype is torch.float32 and idx.dtype is torch.int32
            and tab.ndim == 2 and idx.ndim == 2 and idx.shape[1] == tab.shape[1]
            and tab.shape[1] % 4 == 0 and tab.is_contiguous() and idx.is_contiguous()
            and idx.get_device() == tab.get_device()
            and (tab.data_ptr() | idx.data_ptr()) % 16 == 0
            and idx.numel() < 2**31 and tab.numel() < 2**31):
        _explain_gather(tab, idx)
    p, c = idx.shape
    out = tab.new_empty((p, c))
    err = _lib.lib().spi_row_gather(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), p, c,
                                    tab.shape[0], _lib.stream_handle(tab.device))
    _lib.check(err, "row_gather")
    _lib.launch_counts["row_gather"] += 1
    return out


def _explain_gather(tab, idx):
    """Raise the reason why `row_gather_cuda` does not take these inputs."""
    _check_gather(tab, idx)
    _lib.require(tab, "table", ndim=2, align=16)
    _lib.require(idx, "indices", dtype=torch.int32, device=tab.device, ndim=2, align=16)
    if tab.shape[1] % 4:
        raise ValueError(f"row_gather kernel takes C a multiple of 4, got {tab.shape[1]}")
    raise ValueError("row_gather kernel takes fewer than 2^31 elements per tensor")


def row_gather(tab, idx):
    """out[i, j] = tab[idx[i, j], j]: the kernel for CUDA tensors, else
    `row_gather_plain`."""
    return (row_gather_cuda if tab.is_cuda else row_gather_plain)(tab, idx)


def _flat_rows(rows, upd):
    if upd.ndim != 2 or rows.numel() != upd.shape[0] or rows.ndim not in (1, 2):
        raise ValueError(f"rows {tuple(rows.shape)} and updates {tuple(upd.shape)} do not match")
    return rows.reshape(-1)


def row_scatter_add_plain(rows, upd, n_out: int):
    """The plain PyTorch version: `index_add_` into zeros at the wrapped
    rows, with rows out of range sent to row 0 with a zero update."""
    r, keep = _wrap(_flat_rows(rows, upd).long(), n_out)
    out = torch.zeros(n_out, upd.shape[1], dtype=torch.float32, device=upd.device)
    return out.index_add_(0, torch.where(keep, r, 0), torch.where(keep[:, None], upd.float(), 0.0))


def row_scatter_add_binned(rows, upd, n_out: int):
    """The kernel's algorithm in plain PyTorch. Returns the same table as
    `row_scatter_add_plain` and {'parts': blocks of the sum pass that
    work, 'pieces': run pieces added by a reduction, 'reductions': float4
    reductions the kernel issues (pieces x C / 4)}.

    1. Count: each live update's bucket, its wrapped row // SLICE_ROWS.
    2. Scan: where each bucket's entries start; a bucket of more than
       BUCKET_SPLIT entries is split into parts of BUCKET_SPLIT.
    3. Place: each live update's index into its bucket's range (here in
       update order; the kernel's order within a bucket is its atomics').
    4. Sum, a part at a time: the part's entries sorted by row within the
       slice, each row's run summed. A bucket of one part stores every
       row of its slice once: a run of at most RUN_SPLIT entries as its
       sum, a row with no update as zeros, a longer run as zeros, then
       added in pieces of RUN_SPLIT entries. A split bucket's slice is
       zeroed by the place pass, and each part adds every run it holds in
       pieces of RUN_SPLIT.
    """
    r, live = _wrap(_flat_rows(rows, upd).long(), n_out)
    c = upd.shape[1]
    dev = upd.device
    n_buckets = -(-n_out // SLICE_ROWS)
    index = live.nonzero().reshape(-1)  # 3. placed in update order
    row = r[index]
    bucket = row // SLICE_ROWS
    order = torch.sort(bucket, stable=True).indices
    index, row, bucket = index[order], row[order], bucket[order]
    counts = torch.bincount(bucket, minlength=n_buckets)  # 1.
    offsets = torch.cumsum(counts, 0) - counts  # 2.
    split = counts > BUCKET_SPLIT
    parts = int(torch.clamp((counts + BUCKET_SPLIT - 1) // BUCKET_SPLIT, min=1).sum())
    # 4. Each entry's part, then its run (part, row) and its place in the run.
    part = bucket * (index.numel() + 1) + (torch.arange(index.numel(), device=dev)
                                           - offsets[bucket]) // BUCKET_SPLIT
    by_run = torch.sort(part * n_out + row, stable=True)
    index, row, bucket = index[by_run.indices], row[by_run.indices], bucket[by_run.indices]
    _, run_of, run_len = torch.unique_consecutive(by_run.values, return_inverse=True,
                                                  return_counts=True)
    run_start = torch.cumsum(run_len, 0) - run_len
    in_run = torch.arange(index.numel(), device=dev) - run_start[run_of]
    pieced = split[bucket] | (run_len[run_of] > RUN_SPLIT)
    vals = upd.float()[index]
    out = torch.zeros(n_out, c, dtype=torch.float32, device=dev)
    whole = ~pieced  # runs stored as one sum
    out.index_add_(0, row[whole], vals[whole])
    piece = (run_of * (RUN_SPLIT + index.numel()) + in_run // RUN_SPLIT)[pieced]
    piece_key, piece_of = torch.unique(piece, return_inverse=True)
    sums = torch.zeros(piece_key.numel(), c, dtype=torch.float32, device=dev)
    sums.index_add_(0, piece_of, vals[pieced])
    piece_row = torch.zeros(piece_key.numel(), dtype=torch.long, device=dev)
    piece_row[piece_of] = row[pieced]
    out.index_add_(0, piece_row, sums)
    n_pieces = piece_key.numel()
    return out, {"parts": parts, "pieces": n_pieces, "reductions": n_pieces * (c // 4)}


def scatter_scratch_ints(n: int, n_out: int) -> int:
    """int32 entries of the scratch the kernel works in: each part's
    (first entry, end, bucket, split) as an int4, the count pass's
    per-block bucket counts and their prefixes over the blocks, each
    bucket's total, the number of parts, the placed index list, each
    placed entry's row within its slice (one byte) and each update's rank
    among its count block's updates of its bucket (two bytes)."""
    buckets = -(-n_out // SLICE_ROWS)
    blocks = -(-n // CHUNK)
    max_parts = buckets + -(-n // BUCKET_SPLIT)
    return 4 * max_parts + 2 * blocks * buckets + buckets + 1 + n + -(-n // 4) + -(-n // 2)


def _check_scatter(rows, upd, n_out: int):
    """The flat rows, n and C of inputs the kernel takes; raise otherwise."""
    r = _flat_rows(rows, upd)
    _lib.require(upd, "updates", ndim=2, align=16)
    _lib.require(rows, "rows", dtype=torch.int32, device=upd.device)
    n, c = upd.shape
    if c % 4:
        raise ValueError(f"row_scatter_add kernel takes C a multiple of 4, got {c}")
    if upd.numel() >= 2**31 or n_out * c >= 2**31:
        raise ValueError("row_scatter_add kernel takes fewer than 2^31 elements per tensor")
    if n_out > MAX_ROWS:
        raise ValueError(f"row_scatter_add kernel takes at most {MAX_ROWS} table rows, "
                         f"got {n_out}")
    return r, n, c


def row_scatter_add_binned_cuda(rows, upd, n_out: int):
    """The kernel's binned route: same function as `row_scatter_add_plain`.
    The output and the scratch come from `torch.empty`; the kernel writes
    every row of the table."""
    r, n, c = _check_scatter(rows, upd, n_out)
    out = torch.empty(n_out, c, dtype=torch.float32, device=upd.device)
    if n_out:
        need = scatter_scratch_ints(n, n_out)
        scratch = torch.empty(need, dtype=torch.int32, device=upd.device)
        err = _lib.lib().spi_row_scatter_add(r.data_ptr(), upd.data_ptr(), out.data_ptr(),
                                             scratch.data_ptr(), need, n, c, n_out,
                                             _lib.stream_handle(upd.device))
        _lib.check(err, "row_scatter_add")
        _lib.launch_counts["row_scatter_add"] += 1
    return out


def row_scatter_add_atomic_cuda(rows, upd, n_out: int):
    """The kernel's atomic route: same function as `row_scatter_add_plain`;
    the kernel zeroes the table, then adds each update row into it."""
    r, n, c = _check_scatter(rows, upd, n_out)
    out = torch.empty(n_out, c, dtype=torch.float32, device=upd.device)
    if n_out:
        err = _lib.lib().spi_row_scatter_add_atomic(r.data_ptr(), upd.data_ptr(),
                                                    out.data_ptr(), n, c, n_out,
                                                    _lib.stream_handle(upd.device))
        _lib.check(err, "row_scatter_add")
        _lib.launch_counts["row_scatter_add"] += 1
    return out


def row_scatter_add_cuda(rows, upd, n_out: int):
    """Launch the scatter-add kernel on the route `scatter_route` picks for
    these inputs on this card: same function as `row_scatter_add_plain`.
    C must be a multiple of 4 and n_out at most MAX_ROWS."""
    c = upd.shape[1] if upd.ndim == 2 else 0
    l2_bytes = torch.cuda.get_device_properties(upd.device).L2_cache_size if upd.is_cuda else 0
    atomic = scatter_route(c, n_out, l2_bytes) == "atomic"
    return (row_scatter_add_atomic_cuda if atomic else row_scatter_add_binned_cuda)(rows, upd,
                                                                                     n_out)


def row_scatter_add(rows, upd, n_out: int):
    """zeros(n_out, C).at[rows].add(upd): the kernel for CUDA tensors, else
    `row_scatter_add_plain`."""
    return (row_scatter_add_cuda if upd.is_cuda else row_scatter_add_plain)(rows, upd, n_out)
