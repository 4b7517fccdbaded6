#!/usr/bin/env python3
"""Where the time of the port's fused build goes, on one CUDA card.

    python scripts/profile_fused_torch.py [--size-mb 64] [--top 20]
    python scripts/profile_fused_torch.py --stream --size-mb 1024 \
        --copies 32

Builds chip_smoke.py's pan-genome input (seed 4321, w=10, p=100, 8
copies unless --copies), runs pfbwtf_tpu_torch's fused build (with
--stream the streamed build, checksum-only, default chunk target and J2
switch) once to warm up, once more unprofiled for the stage times, then
once under torch.profiler (CPU and CUDA activities).  Prints the stage seconds of the unprofiled run, the wall
seconds of the profiled run, the device time summed over all kernels and
its share of that wall time (the device-busy share; the rest is idle),
and the ops with the most device time.  Needs a CUDA card.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size-mb", type=int, default=64)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--copies", type=int, default=8)
    ap.add_argument("--stream", action="store_true",
                    help="the streamed build (--fused -m)")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
    from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream
    from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

    records = chip_smoke.pangenome_records(args.size_mb, copies=args.copies)
    params = ParserParams(w=chip_smoke.W, p=chip_smoke.P)
    if args.stream:
        C, _, _ = build_stream(records, params)
        del records

    def run():
        if args.stream:
            info = {}
            pfbwt_fused_stream(C, params.w, params.p, device="cuda",
                               info=info)
            return None, info
        return pfbwt_fused_records(records, params, device="cuda",
                                   want_sa=True, want_rssa=True)

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, info = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"card: {chip_smoke._nvidia_smi()}")
    if args.stream:
        print(f"{args.size_mb} MB streamed, unprofiled: e2e {wall:.4f} s, "
              f"{chip_smoke.stage_line(info)}; peak so far as J2, J3a and "
              f"the chunks ended {info['peak_j2']}, {info['peak_j3a']}, "
              f"{info['peak_chunks']} B")
    else:
        print(f"{args.size_mb} MB unprofiled: e2e {wall:.4f} s, host_s "
              f"{info['host_s']:.4f}, j2_s {info['j2_s']:.4f}, j3_s "
              f"{info['j3_s']:.4f}, fetch_s {info['fetch_s']:.4f}, records "
              f"to stream {info['stream_s']:.4f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = prof.key_averages()
    # device events (kernels, copies) carry the device time once; CPU ops
    # carry the device time of the kernels they launched, for the table
    dev_us = sum(_device_us(e) for e in events
                 if e.device_type != DeviceType.CPU)
    print(f"{args.size_mb} MB profiled: wall {pwall:.4f} s, device time "
          f"{dev_us / 1e6:.4f} s, device-busy share {dev_us / 1e6 / pwall:.4f}")
    if dev_us == 0:
        print("the profiler recorded no device time")
        return 1
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    rows = sorted(ops, key=_device_us, reverse=True)[: args.top]
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  op")
    for e in rows:
        us = _device_us(e)
        print(f"{us / 1e3:10.3f} {us / dev_us:6.3f} {e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
