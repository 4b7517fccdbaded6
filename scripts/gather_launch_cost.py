#!/usr/bin/env python3
"""Host cost of a gather launch on one CUDA card, part by part.

    python scripts/gather_launch_cost.py [calls]

Times on the host clock, in microseconds a call (the median of 7 rounds
of ``calls`` calls, default 2000), what the enqueue of a K2 launch
(ops/cuda/gather.take) and of torch.take spend, at a small index length
(4096) so that the card keeps up and the host is what is timed: the whole
wrapper, the dispatch by device (ops/gather.take), torch.take on int64
indices, and each part of the wrapper's path on its own, with the
alternatives it was chosen over ("(other)").  Then the
one-launch-at-a-time and batched CUDA-event times of K2 and torch.take at
the probe's shape, as chip_smoke.py takes them, with the gap between the
two for each.  Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host_us(fn, calls: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(rounds))


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _median_ms
    from pfbwtf_tpu_torch.ops import gather
    from pfbwtf_tpu_torch.ops.cuda import build
    from pfbwtf_tpu_torch.ops.cuda import gather as kernels

    argv = sys.argv[1:] if argv is None else argv
    calls = int(argv[0]) if argv else 2000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t = 1 << 20
    table = torch.randint(0, 1 << 30, (t,), generator=gen, device="cuda",
                          dtype=torch.int32)
    idx = torch.randint(0, t, (4096,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    dev = idx.get_device()
    fns = build.functions("gather", kernels.SIGNATURES)
    fn = fns["pfbwt_take_l2"]
    out = torch.empty_like(idx)
    stream = build.current_stream(dev)
    args = (table.data_ptr(), t, idx.data_ptr(), out.data_ptr(), 4096, dev,
            stream)
    limit_fn = fns["pfbwt_gather_smem_limit"]
    held = ctypes.PyDLL(build.library_path("gather")).pfbwt_take_l2
    held.argtypes, held.restype = kernels.SIGNATURES["pfbwt_take_l2"]
    parts = (
        ("K2 wrapper, whole (ops/cuda/gather.take)",
         lambda: kernels.take(table, idx)),
        ("K2 through the dispatch (ops/gather.take)",
         lambda: gather.take(table, idx)),
        ("torch.take, int64 indices", lambda: torch.take(table, idx64)),
        ("  the C launcher alone, arguments ready", lambda: fn(*args)),
        ("  the output, output_like", lambda: kernels.output_like(idx)),
        ("  the stream, build.current_stream",
         lambda: build.current_stream(dev)),
        ("  the functions, build.functions",
         lambda: build.functions("gather", kernels.SIGNATURES)),
        ("  the tier, gather_tier(smem_limit)",
         lambda: kernels.gather_tier(4 * t, kernels._smem_limit(fns, dev))),
        ("  the checks' tensor reads (dtype, dim, contiguity, is_cuda, "
         "get_device)",
         lambda: (table.dtype, table.dim(), table.is_contiguous(),
                  table.is_cuda, idx.dtype, idx.dim(), idx.is_contiguous(),
                  idx.is_cuda, table.get_device() == idx.get_device())),
        ("  three data_ptr()",
         lambda: (table.data_ptr(), idx.data_ptr(), out.data_ptr())),
        ("  (other) a C call that launches nothing (the limit query)",
         lambda: limit_fn(dev)),
        ("  (other) the C launcher with n = 0 (arguments, no launch)",
         lambda: fn(*args[:4], 0, *args[5:])),
        ("  (other) the C launcher through ctypes.PyDLL (lock held)",
         lambda: held(*args)),
        ("  (other) torch.empty_like", lambda: torch.empty_like(idx)),
        ("  (other) torch.empty(n, dtype, device)",
         lambda: torch.empty(4096, dtype=torch.int32, device=idx.device)),
        ("  (other) torch.cuda.current_stream(device).cuda_stream",
         lambda: torch.cuda.current_stream(idx.device).cuda_stream),
        ("  (other) torch.cuda.current_device()", torch.cuda.current_device),
        ("  (other) device.type and device equality for the device checks",
         lambda: (table.device.type, idx.device.type,
                  table.device != idx.device)),
    )
    for label, f in parts:
        print(f"{label:62s} {_host_us(f, calls):8.2f} us a call")
    idx = torch.randint(0, t, (1 << 24,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    for label, f in (("K2", lambda: kernels.take(table, idx)),
                     ("torch.take", lambda: torch.take(table, idx64))):
        one = _median_ms(f, 50)
        batched = _median_ms(f, 20, per=20)
        print(f"{label} at 2^20 entries, 2^24 indices: {one:.4f} ms one "
              f"launch at a time, {batched:.4f} ms batched, gap "
              f"{one - batched:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
