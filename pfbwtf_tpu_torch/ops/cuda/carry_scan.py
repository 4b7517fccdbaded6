"""ctypes wrapper of kernel K5, the carry scan (csrc/carry_scan.cu).

``carry`` takes a 1-D contiguous int64 tensor on a CUDA card and returns
its inclusive running max or min, forward or in reverse; ``posrank``
takes a dict doubling round's sorted keys and permutation and returns
its positional ranks and group count.  Each launches K5 on the card's
current stream (no synchronisation) or raises; the inputs are checked
before anything touches a card.  The plain versions and the dispatch by
device are in ops/carry.py.  ``launches`` counts the launches by entry,
and each is counted as ``k5_launches`` in the open build (utils/timer).
"""

import ctypes

import torch

from ...utils.timer import count
from . import build
from .gather import output_like

launches = {"carry": 0, "posrank": 0}

_OPS = {"max": 0, "min": 1}
SIGNATURES = {
    "pfbwt_carry_tile": ([], ctypes.c_longlong),
    "pfbwt_carry_scan": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ], ctypes.c_int),
    "pfbwt_posrank": ([
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ], ctypes.c_int),
}


def _check(name: str, **tensors):
    """Type, shape and layout of every tensor first, then the device."""
    for what, t in tensors.items():
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"{name}: {what} must be a 1-D int64 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: unsupported device {t.device} ({what})")


def tile_lanes() -> int:
    """The lanes of one tile, one block's share of a launch."""
    return build.functions("carry_scan", SIGNATURES)["pfbwt_carry_tile"]()


def _state(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The zeroed state words of a launch over x and its tile count."""
    h = x.data_ptr() % 16 // 8
    tile = tile_lanes()
    ntiles = (x.shape[0] + h + tile - 1) // tile
    return torch.zeros(2 + 3 * ntiles, dtype=torch.int64,
                       device=x.device), ntiles


def _run(name: str, fn, dev: int, args):
    if dev == torch.cuda.current_device():
        rc = fn(*args)
    else:  # a device context only where another card is current
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    count("k5_launches")


def carry(x: torch.Tensor, op: str, reverse: bool = False) -> torch.Tensor:
    """The inclusive running ``op`` ("max" or "min") of x, from its first
    lane on (or, with ``reverse``, from its last lane back)."""
    if op not in _OPS:
        raise ValueError(f"carry: op must be one of {sorted(_OPS)}")
    _check("carry", x=x)
    n = x.shape[0]
    y = output_like(x)
    if n == 0:
        return y
    fns = build.functions("carry_scan", SIGNATURES)
    state, ntiles = _state(x)
    dev = x.get_device()
    _run("carry", fns["pfbwt_carry_scan"], dev, (
        x.data_ptr(), y.data_ptr(), n, _OPS[op], int(reverse),
        state.data_ptr(), ntiles, build.current_stream(dev)))
    return y


def posrank(cks: torch.Tensor, order: torch.Tensor):
    """rank[order[i]] = the last j <= i with j = 0 or cks[j] != cks[j - 1],
    and the number of such j, as (rank, counts) with counts a 1-lane
    int64 tensor on the card."""
    _check("posrank", cks=cks, order=order)
    if order.shape[0] != cks.shape[0]:
        raise ValueError("posrank: cks and order differ in length")
    if order.get_device() != cks.get_device():
        raise ValueError("posrank: cks and order on different cards")
    n = cks.shape[0]
    rank = torch.empty(n, dtype=torch.int64, device=cks.device)
    if n == 0:
        return rank, torch.zeros(1, dtype=torch.int64, device=cks.device)
    if order.data_ptr() % 16 != cks.data_ptr() % 16:
        order = output_like(cks).copy_(order)
    fns = build.functions("carry_scan", SIGNATURES)
    state, ntiles = _state(cks)
    dev = cks.get_device()
    _run("posrank", fns["pfbwt_posrank"], dev, (
        cks.data_ptr(), order.data_ptr(), rank.data_ptr(), n,
        state.data_ptr(), ntiles, build.current_stream(dev)))
    return rank, state[:1]
