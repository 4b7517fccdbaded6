"""ctypes wrappers of kernels K2, K3 and K4, the table gathers
(csrc/gather.cu).

Each takes a 1-D int32 table and a 1-D int32 index tensor on one CUDA
card, launches its kernel on the card's current stream (no
synchronisation; the C side makes the card current only where another
is) and returns the int32 output, or raises.  Their plain versions are in
ops/gather.py, which also holds the dispatch by device.  ``launches``
counts the launches of each kernel by wrapper name, ``tier_launches``
the launches of each tier.

The kernel has two tiers (``gather_tier``): a table that fits one
block's shared memory is staged there ("smem"); a larger one is read
from device memory through the L2 ("l2").  The tier follows from the
table's size and the limit the C side reports for the card; nothing else
selects it.

``take`` (K2) does not check its indices: they are promised in [0, T),
as ``mode="promise_in_bounds"`` promises, and a check would cost a host
synchronisation.  ``take_along`` (K3) and ``take_rows`` (K4) define every
index.
"""

import ctypes

import torch

from . import build

launches = {"take": 0, "take_along": 0, "take_rows": 0}
tier_launches = {"smem": 0, "l2": 0}

_LAUNCH_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_void_p], ctypes.c_int)
SIGNATURES = {"pfbwt_gather_smem_limit": ([ctypes.c_int], ctypes.c_int)}
_SYMBOLS = {(name, tier): f"pfbwt_{name}_{tier}"
            for name in launches for tier in tier_launches}
SIGNATURES.update({symbol: _LAUNCH_ARGS for symbol in _SYMBOLS.values()})

_smem_limits = {}  # card -> bytes


def gather_tier(table_bytes: int, smem_limit: int) -> str:
    """The tier for a table of ``table_bytes``: "smem" when it fits
    ``smem_limit``, the table bytes a block's shared memory takes on the
    card (``pfbwt_gather_smem_limit``), else "l2"."""
    return "smem" if table_bytes <= smem_limit else "l2"


def smem_limit(dev: int) -> int:
    """The shared-memory tier's limit in table bytes on card ``dev``, read
    from the C side once a card."""
    return _smem_limit(build.functions("gather", SIGNATURES), dev)


def _smem_limit(fns: dict, dev: int) -> int:
    limit = _smem_limits.get(dev)
    if limit is None:
        limit = fns["pfbwt_gather_smem_limit"](dev)
        if limit < 0:
            raise RuntimeError(f"gather: reading card {dev}'s shared memory "
                               f"failed: CUDA error {-limit}")
        _smem_limits[dev] = limit
    return limit


def output_like(idx: torch.Tensor) -> torch.Tensor:
    """An output of idx's length and type at idx's address modulo 16, so
    that a kernel's vector loads and stores align together: ``empty_like``
    for an aligned idx (every fresh allocation is), else a view into a
    buffer 16 bytes less one lane longer (K2-K4's int32 indices, K5's
    int64 lanes)."""
    shift = idx.data_ptr() % 16
    if shift == 0:
        return torch.empty_like(idx)
    n, size = idx.shape[0], idx.element_size()
    buf = torch.empty(n + 16 // size - 1, dtype=idx.dtype, device=idx.device)
    lead = (shift - buf.data_ptr() % 16) % 16 // size
    return buf[lead: lead + n]


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor):
    for what, t in (("table", table), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: {what} must be a 1-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in (("table", table), ("idx", idx)):
        if not t.is_cuda:
            raise ValueError(f"{name}: unsupported device {t.device} ({what})")
    dev = idx.get_device()
    if table.get_device() != dev:
        raise ValueError(f"{name}: table and idx on different cards")
    t = table.shape[0]
    if t == 0:
        raise ValueError(f"{name}: the table is empty")
    out = output_like(idx)
    n = idx.shape[0]
    if n == 0:
        return out
    fns = build.functions("gather", SIGNATURES)
    tier = gather_tier(4 * t, _smem_limit(fns, dev))
    rc = fns[_SYMBOLS[name, tier]](
        table.data_ptr(), t, idx.data_ptr(), out.data_ptr(), n, dev,
        build.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({tier} tier): "
                           f"CUDA error {rc}")
    launches[name] += 1
    tier_launches[tier] += 1
    return out


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2: out[i] = table[idx[i]], idx promised in [0, len(table))."""
    return _launch("take", table, idx)


def take_along(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3: idx in [-T, 0) wraps to idx + T; idx outside [-T, T) gives
    INT32_MIN."""
    return _launch("take_along", table, idx)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4: idx clipped to [0, T - 1]."""
    return _launch("take_rows", table, idx)
