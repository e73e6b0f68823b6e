"""Row gather and row scatter-add (counterparts of the Pallas probes
`gather_kernel` in tools/profile_gather.py and the serial RMW `kernel` in
tools/probe_scatter_r5.py).

- `row_gather(tab, idx)`: out[i, j] = tab[idx[i, j], j] (take_along_axis
  on axis 0) for a (R, C) float32 table and (P, C) int32 indices, any P.
- `row_scatter_add(rows, upd, n_out)`: zeros(n_out, C).at[rows].add(upd)
  for (P,) or (P, 1) int32 rows and (P, C) float32 updates; rows outside
  [0, n_out) are dropped, as JAX's scatter drops them.

On a CUDA tensor each launches its kernel (`csrc/row_gather.cu`,
`csrc/row_scatter_add.cu`); on a CPU tensor it runs the plain version
(`torch.gather`, `index_add_`).
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops import _lib


def _check_gather(tab, idx):
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[1] != tab.shape[1]:
        raise ValueError(f"table {tuple(tab.shape)} and indices {tuple(idx.shape)} do not match")


def row_gather_plain(tab, idx):
    """The plain PyTorch version: `torch.gather` on axis 0 (int64 indices)."""
    _check_gather(tab, idx)
    return torch.gather(tab, 0, idx.long())


def row_gather_cuda(tab, idx):
    """Launch the gather kernel: same function as `row_gather_plain` for
    indices in range (an index out of range gives 0). C must be a
    multiple of 4.

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
    """The plain PyTorch version: `index_add_` into zeros, with rows out of
    range sent to row 0 with a zero update."""
    r = _flat_rows(rows, upd).long()
    keep = (r >= 0) & (r < n_out)
    out = torch.zeros(n_out, upd.shape[1], dtype=torch.float32, device=upd.device)
    return out.index_add_(0, torch.where(keep, r, 0), torch.where(keep[:, None], upd.float(), 0.0))


def row_scatter_add_cuda(rows, upd, n_out: int):
    """Launch the scatter-add kernel: same function as
    `row_scatter_add_plain`. C must be a multiple of 4."""
    r = _flat_rows(rows, upd)
    _lib.require(upd, "updates", ndim=2, align=16)
    _lib.require(rows, "rows", dtype=torch.int32, device=upd.device)
    n, c = upd.shape
    if c % 4:
        raise ValueError(f"row_scatter_add kernel takes C a multiple of 4, got {c}")
    if upd.numel() >= 2**31 or n_out * c >= 2**31:
        raise ValueError("row_scatter_add kernel takes fewer than 2^31 elements per tensor")
    out = torch.empty(n_out, c, dtype=torch.float32, device=upd.device)
    err = _lib.lib().spi_row_scatter_add(r.data_ptr(), upd.data_ptr(), out.data_ptr(), n, c,
                                         n_out, _lib.stream_handle(upd.device))
    _lib.check(err, "row_scatter_add")
    _lib.launch_counts["row_scatter_add"] += 1
    return out


def row_scatter_add(rows, upd, n_out: int):
    """zeros(n_out, C).at[rows].add(upd): the kernel for CUDA tensors, else
    `row_scatter_add_plain`."""
    return (row_scatter_add_cuda if upd.is_cuda else row_scatter_add_plain)(rows, upd, n_out)
