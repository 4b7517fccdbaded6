"""ctypes wrappers of kernels K2, K3 and K4, the table gathers
(csrc/gather.cu).

Each takes a 1-D int32 table and a 1-D int32 index tensor on one CUDA
card, launches its kernel on the current stream (no synchronisation) and
returns the int32 output, or raises.  Their plain versions are in
ops/gather.py, which also holds the dispatch by device.  ``launches``
counts the launches of each kernel by wrapper name.

``take`` (K2) does not check its indices: they are promised in [0, T),
as ``mode="promise_in_bounds"`` promises, and a check would cost a host
synchronisation.  ``take_along`` (K3) and ``take_rows`` (K4) define every
index.
"""

import ctypes

import torch

from . import build

launches = {"take": 0, "take_along": 0, "take_rows": 0}

_SYMBOLS = {"take": "pfbwt_take", "take_along": "pfbwt_take_along",
            "take_rows": "pfbwt_take_rows"}


def _fn(name: str):
    fn = getattr(build.load("gather"), _SYMBOLS[name])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _aligned_like(idx: torch.Tensor) -> torch.Tensor:
    """An int32 output of idx's length whose address equals idx's modulo
    16, so that the kernel's vector loads and stores align together."""
    buf = torch.empty(idx.shape[0] + 3, dtype=torch.int32, device=idx.device)
    shift = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[shift: shift + idx.shape[0]]


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor):
    for what, t in (("table", table), ("idx", idx)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name}: {what} must be a 1-D int32 tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in (("table", table), ("idx", idx)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device} ({what})")
    if table.device != idx.device:
        raise ValueError(f"{name}: table and idx on different cards")
    if table.shape[0] == 0:
        raise ValueError(f"{name}: the table is empty")
    out = _aligned_like(idx)
    n = idx.shape[0]
    if n == 0:
        return out
    fn = _fn(name)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), table.shape[0], idx.data_ptr(),
                out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
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
