"""Gather probe: kernels K2-K4 against torch.take at the shape of the TPU
gather probe (benchmarks/gather_probe.py).

    python -m pfbwtf_tpu_torch.probes.gather_probe [table_elems] [n_idx]

The table holds ``table_elems`` int32 values from [0, 2^30) and the
indices are ``n_idx`` int32 values from [0, table_elems), both drawn from
``np.random.default_rng(0)`` as the TPU probe draws them (defaults 2^20
and 2^24).  Prints, for torch.take (the counterpart of the probe's
``xla_take``) and for each kernel, the time, the GB/s of indices and
whether the output matches torch.take's; on the card also the kernels'
tier for this table (shared memory or L2).  On the card the times are
CUDA-event medians; with ``device="cpu"`` the plain versions run and the
times are the host clock's.
"""

import sys
import time

import numpy as np
import torch

from ..ops import gather
from ..ops.cuda import gather as kernels

TABLE_ELEMS = 1 << 20
N_IDX = 1 << 24


def _time_ms(fn, dev: torch.device, iters: int = 5):
    """(output, median milliseconds) over ``iters`` calls after a warm-up."""
    out = fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def main(argv=None, device="cuda") -> dict:
    """Run the probe; returns {label: (ms, matches)} (torch.take's
    ``matches`` is None)."""
    from ..utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    tbl = int(argv[0]) if len(argv) > 0 else TABLE_ELEMS
    nidx = int(argv[1]) if len(argv) > 1 else N_IDX
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        rng.integers(0, 1 << 30, size=tbl, dtype=np.int32)).to(dev)
    idx = torch.from_numpy(
        rng.integers(0, tbl, size=nidx, dtype=np.int32)).to(dev)
    idx64 = idx.to(torch.int64)  # torch.take takes int64 indices only
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"table {tbl} i32 ({tbl * 4 / 1e6:.1f} MB), idx {nidx}, "
          f"{dev} ({clock})")
    if dev.type == "cuda":
        limit = kernels.smem_limit(table.device.index)
        print(f"kernel tier: {kernels.gather_tier(4 * tbl, limit)} (tables "
              f"up to {limit} B take the shared-memory tier on this card)")
    ref, ms = _time_ms(lambda: torch.take(table, idx64), dev)
    results = {"torch.take": (ms, None)}
    print(f"{'torch.take':28s} {ms:9.4f} ms  "
          f"{nidx * 4 / ms / 1e6:7.1f} GB/s-of-idx")
    for label, fn in (("K2 take", gather.take),
                      ("K3 take_along", gather.take_along),
                      ("K4 take_rows", gather.take_rows)):
        out, ms = _time_ms(lambda: fn(table, idx), dev)
        ok = bool(torch.equal(out, ref))
        results[label] = (ms, ok)
        print(f"{label:28s} {ms:9.4f} ms  "
              f"{nidx * 4 / ms / 1e6:7.1f} GB/s-of-idx")
        print(f"    matches torch.take: {ok}")
    return results


if __name__ == "__main__":
    main()
