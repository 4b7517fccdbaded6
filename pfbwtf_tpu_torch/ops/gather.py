"""Table gathers of the TPU gather probe (benchmarks/gather_probe.py):
the plain PyTorch versions of kernels K2-K4 and the dispatch by device.

``take``, ``take_along`` and ``take_rows`` run the plain version on a
CPU tensor and the kernel (ops/cuda/gather.py) on a CUDA tensor, which
launches or raises.  The three differ only on indices outside [0, T):

- ``take`` (K2): promised in range; the plain version raises on one.
- ``take_along`` (K3): [-T, 0) wraps to idx + T, the rest gives INT32_MIN,
  as jnp.take_along_axis fills a signed type.
- ``take_rows`` (K4): clipped to [0, T - 1].
"""

import torch

from .cuda import gather as kernels

INT32_MIN = -(1 << 31)


def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.to(torch.int64)]


def take_along_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    t = table.shape[0]
    j = idx.to(torch.int64)
    j = torch.where(j < 0, j + t, j)
    ok = (j >= 0) & (j < t)
    return torch.where(ok, table[torch.clamp(j, 0, t - 1)], INT32_MIN).to(
        table.dtype)


def take_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)]


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device.type == "cpu":
        return take_plain(table, idx)
    return kernels.take(table, idx)


def take_along(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device.type == "cpu":
        return take_along_plain(table, idx)
    return kernels.take_along(table, idx)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device.type == "cpu":
        return take_rows_plain(table, idx)
    return kernels.take_rows(table, idx)
