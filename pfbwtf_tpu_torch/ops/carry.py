"""J3's running maxima and minima: the plain PyTorch versions of kernel
K5 (ops/cuda/carry_scan.py) and the dispatch by device.

``carry_max`` and ``carry_min`` give the inclusive running max or min of
a 1-D int64 tensor, from its first lane or (``reverse``) from its last;
``posrank`` gives one dict doubling round's positional ranks and group
count from its sorted keys and permutation.  Each runs the plain version
on a CPU tensor and the kernel on a CUDA tensor, which launches or
raises.
"""

import torch

from .cuda import carry_scan as kernels


def carry_plain(x: torch.Tensor, op: str, reverse: bool = False):
    scan = {"max": torch.cummax, "min": torch.cummin}[op]
    if reverse:
        return scan(x.flip(0), 0).values.flip(0)
    return scan(x, 0).values


def posrank_plain(cks: torch.Tensor, order: torch.Tensor):
    n = cks.shape[0]
    changed = torch.ones(n, dtype=torch.bool, device=cks.device)
    changed[1:] = cks[1:] != cks[:-1]
    idx = torch.arange(n, device=cks.device)
    headpos = torch.cummax(torch.where(changed, idx, 0), 0).values
    rank = torch.empty_like(headpos)
    rank[order] = headpos
    return rank, changed.sum().reshape(1)


def carry_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return carry_plain(x, "max", reverse)
    return kernels.carry(x, "max", reverse)


def carry_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return carry_plain(x, "min", reverse)
    return kernels.carry(x, "min", reverse)


def posrank(cks: torch.Tensor, order: torch.Tensor):
    """(rank, counts): rank[order[i]] = the sorted position of the head of
    lane i's group of equal keys, counts = [groups] on the device."""
    if cks.device.type == "cpu":
        return posrank_plain(cks, order)
    return kernels.posrank(cks, order)
