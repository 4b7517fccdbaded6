#!/usr/bin/env python3
"""Smoke run of pfbwtf_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last
line:

1. Environment: the card's name and power limit (nvidia-smi), the torch
   and CUDA versions, and the build of every kernel in
   pfbwtf_tpu_torch/csrc/ (one nvcc per source, started together).
2. Kernel K1 (the cut scan) against its plain PyTorch version on the
   card, bit for bit, over a (w, p) grid (p up to 2**64 - 1), ragged and
   short lengths and a view that starts one byte past an allocation, with
   k-mers planted whose hashes are multiples of p; then at the main
   path's shape with the 64 MB input's own codes: CUDA-event median times
   of both (K1 one launch at a time, and in batches of 20 back to back),
   K1's bound and the share of it reached by each time.
3. The yardstick of the TPU gather probe's kernels K2-K4, which the port
   does not have: torch.take at their shape, beside their bytes bound.
4. The whole fused build of a 1 MB pan-genome on the card against the
   same build on the CPU, through pfbwt_fused_records and through the
   CLI (``--fused -s -r``): .bwt/.sa/.ssa/.esa bytes must be identical.
5. The main path: the fused build of the 64 MB pan-genome of bench.py
   (8 mutated copies of an 8 MiB unit, SNP rate 0.001, w=10, p=100, seed
   4321) with the kernel launch counts set to 0 just before and read just
   after.  Stage times, peak device memory, n, r, checksum and doubling
   rounds are printed; the SA must be a permutation of [0, n] and every
   BWT char the one before its suffix.

Then one JSON line of kernel numbers, the nvidia-smi line, and last the
JSON result line.  Needs a CUDA card; without one it exits 2 and prints
no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, P = 10, 100
PAN_COPIES, PAN_SNP_RATE, PAN_SEED = 8, 0.001, 4321
K1_GRID = ((10, 100), (1, 3), (16, 511), (17, 97), (32, 97),
           (10, (1 << 15) + 3), (4, (1 << 20) - 1)) + tuple(
    (w, p) for w in (31, 32)
    for p in (1, 2, 64, 1 << 32, 1 << 63, (1 << 63) + 29, (1 << 64) - 1))
K1_LENGTHS = (1, 15, 16, 17, 2047, 2049, 100_003, 1_000_037)  # and w - 1
K1_OFFSETS = (0, 1)  # codes = buf[off:]; 1 starts off a 16-byte boundary
# the TPU gather probe's shape (benchmarks/gather_probe.py:34-35, 164-168)
GATHER_TABLE, GATHER_IDX = 1 << 20, 1 << 24
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM instruction issue: 132 SMs x 128 lanes x 1.98 GHz (boost), one
# 32-bit instruction per lane per clock
INSN_PER_S = 132 * 128 * 1.98e9


def k1_ops_per_position(w: int) -> float:
    """32-bit instructions that the cut scan's work takes a position,
    counted from the SASS of K1's own hot path (scripts/k1_sass.py, its
    "work" line): what a thread issues for its run of 32 positions, less
    what loads, packs and realigns codes (LDG, PRMT, the IMADs by the
    gather constant, the left funnel shifts by the offset), stores (STG),
    reads parameters (LDC), moves registers (MOV), runs on the uniform
    datapath (U*, S2R, S2UR), forms addresses (VIADD, sign extensions) or
    steers (BRA, BSSY, BSYNC, EXIT, ISETP, SEL).  What remains is the
    k-mer's extraction, the Wang mix, the test by a multiplicative inverse
    and the flag as the compiler fused them: 1029 instructions for 32
    positions at w <= 16, 1142 above.  The parts counted apart (a
    two-instruction k-mer update, 25 for the mix alone, 7 for the test, 2
    for the flag: 36) come to more than the fused code spends.  Recount
    when csrc/hash_scan.cu changes."""
    return (1142 if w > 16 else 1029) / 32


def check(ok: bool, what: str):
    """Fail the smoke run (an explicit raise, kept under python -O)."""
    if not ok:
        raise AssertionError(what)


def pangenome_records(size_mb: int, seed: int = PAN_SEED):
    """bench.py's pan-genome input, in memory: PAN_COPIES mutated copies
    of one random ACGT unit, one record each."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    unit = acgt[rng.integers(0, 4, size=(size_mb << 20) // PAN_COPIES)]
    records = []
    for i in range(PAN_COPIES):
        hap = unit.copy()
        nmut = int(hap.size * PAN_SNP_RATE)
        pos = rng.integers(0, hap.size, size=nmut)
        hap[pos] = acgt[rng.integers(0, 4, size=nmut)]
        records.append((f"hap{i}", hap))
    return records


def write_fasta(path: str, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")


def check_bwt_sa(C: np.ndarray, bwt: np.ndarray, sa: np.ndarray, device):
    """The SA is a permutation of [0, n] with sa[0] = n, and bwt[i] is the
    byte before suffix sa[i] of C (C[n-1] for the terminator suffix n, the
    EOS byte 0 for suffix 0).  Then every adjacent pair (a, b) = (sa[i],
    sa[i+1]) is held to exact suffix order, the terminator ranking below
    every byte: C[a] < C[b], or C[a] == C[b] and ISA[a+1] < ISA[b+1] with
    ISA the inverse of this SA.  A permutation passes that test at every
    pair only if it is the suffix array.  Raises AssertionError on any
    violation."""
    import torch

    n = C.shape[0]
    check(bwt.shape[0] == n + 1 and sa.shape[0] == n + 1, "lengths")
    check(int(sa[0]) == n, "sa[0] must be n")
    sa_t = torch.from_numpy(sa.astype(np.int64)).to(device)
    check(int(sa_t.min()) >= 0 and int(sa_t.max()) <= n, "SA range")
    seen = torch.zeros(n + 1, dtype=torch.bool, device=device)
    seen[sa_t] = True
    check(bool(seen.all()), "SA is not a permutation of [0, n]")
    text = torch.from_numpy(C).to(device)
    prev = torch.where(sa_t > 0, text[torch.clamp(sa_t - 1, min=0)], 0)
    check(torch.equal(prev.to(torch.uint8), torch.from_numpy(bwt).to(device)),
          "bwt[i] is not the byte before suffix sa[i]")
    del seen, prev
    isa = torch.empty_like(sa_t)
    isa[sa_t] = torch.arange(n + 1, device=device)
    ext = torch.full((n + 1,), -1, dtype=torch.int16, device=device)
    ext[:n] = text.to(torch.int16)  # position n: the terminator, -1
    a, b = sa_t[:-1], sa_t[1:]
    ca, cb = ext[a], ext[b]
    # a tie in the first byte never involves the terminator (it occurs
    # once), so a + 1 and b + 1 are <= n there
    ok = (ca < cb) | ((ca == cb)
                      & (isa[torch.clamp(a + 1, max=n)]
                         < isa[torch.clamp(b + 1, max=n)]))
    check(bool(ok.all()), "adjacent SA entries out of suffix order")


def _median_ms(fn, iters: int, per: int = 1) -> float:
    """Median CUDA-event milliseconds per call over ``iters`` samples of
    ``per`` calls back to back.  With per > 1 the host's enqueue of each
    call hides behind the card's work on the one before, so a short
    kernel's time is not its launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    import torch

    from pfbwtf_tpu_torch.ops.cuda import build

    smi = _nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    secs = build.build_all()
    print(f"kernel build: {secs:.2f} s for {build.sources()}")
    for name, log in sorted(build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  nvcc {name}: {line.strip()}")
    return smi


def phase_k1(codes_main: "torch.Tensor"):
    """K1 vs its plain version on the card; returns the kernel's row."""
    import torch

    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.hash import hash_scan
    from pfbwtf_tpu_torch.testing import plant_cuts

    rng = np.random.default_rng(7)
    max_err = runs = planted = 0
    for w, p in K1_GRID:
        for n in K1_LENGTHS + (max(w - 1, 1),):
            for off in K1_OFFSETS:
                buf = rng.integers(0, 4, size=n + off, dtype=np.uint8)
                pos = plant_cuts(buf[off:], w, p)
                codes = torch.from_numpy(buf).cuda()[off:]
                got = k1.cut_scan(codes, w, p)
                want = hash_scan(codes, w, p)
                torch.cuda.synchronize()
                err = int((got.to(torch.int8)
                           - want.to(torch.int8)).abs().max())
                max_err = max(max_err, err)
                where = f"w={w} p={p} n={n} offset={off}"
                check(err == 0, f"K1 differs from plain at {where}")
                check(bool(want[pos].all()),
                      f"a planted k-mer does not cut at {where}")
                runs += 1
                planted += len(pos)
    print(f"K1 grid: {len(K1_GRID)} (w, p) x {len(K1_LENGTHS) + 1} lengths "
          f"x offsets {K1_OFFSETS}: {runs} runs bit-equal to the plain "
          f"version, {planted} planted cuts found")
    n = codes_main.shape[0]
    got = k1.cut_scan(codes_main, W, P)
    want = hash_scan(codes_main, W, P)
    torch.cuda.synchronize()
    err = int((got.to(torch.int8) - want.to(torch.int8)).abs().max())
    max_err = max(max_err, err)
    check(err == 0, "K1 differs from plain at the main-path shape")
    print(f"K1 main-path shape n={n} w={W} p={P}: bit-equal, "
          f"{int(got.sum())} cuts")
    del got, want
    ms = _median_ms(lambda: k1.cut_scan(codes_main, W, P), 50)
    ms_batched = _median_ms(lambda: k1.cut_scan(codes_main, W, P), 20,
                            per=20)
    plain_ms = _median_ms(lambda: hash_scan(codes_main, W, P), 5)
    bytes_ms = 2 * n / HBM_BYTES_PER_S * 1e3
    ops = round(k1_ops_per_position(W) * n)
    ops_ms = ops / INSN_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"K1 time {ms:.4f} ms one launch at a time (the host's enqueue "
          f"included), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {2 * n} B at 3.35 TB/s = {bytes_ms:.4f} ms, {ops} "
          f"32-bit instructions at 33.45 T/s = {ops_ms:.4f} ms), the bound "
          f"is {bound_ms / ms:.3f} of the time")
    print(f"K1 time in batches of 20 launches back to back: "
          f"{ms_batched:.4f} ms, the bound is {bound_ms / ms_batched:.3f} "
          f"of it")
    return {
        "name": "cut_scan", "route": "cuda",
        "source": "pfbwtf_tpu_torch/csrc/hash_scan.cu",
        "replaces": "pfbwtf_tpu/ops/pallas/hash_scan.py:185",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_share": bound_ms / ms,
        "ms_batched": ms_batched, "bound_share_batched": bound_ms / ms_batched,
    }


def phase_gather_yardstick():
    """torch.take at the shape of the TPU gather probe's kernels K2-K4
    (out[i] = table[idx[i]], a table of 2^20 int32 and 2^24 indices).
    The port has no kernel for them; this is the library call their rows
    are held against.  The bound counts the function's bytes: the
    indices read and the output written once, 4 B each, and the table
    read once."""
    import torch

    rng = np.random.default_rng(0)
    table_np = rng.integers(0, 1 << 30, size=GATHER_TABLE, dtype=np.int32)
    idx_np = rng.integers(0, GATHER_TABLE, size=GATHER_IDX, dtype=np.int32)
    table = torch.from_numpy(table_np).cuda()
    idx = torch.from_numpy(idx_np.astype(np.int64)).cuda()  # take: int64
    out = torch.take(table, idx)
    check(np.array_equal(out.cpu().numpy(), table_np[idx_np]),
          "torch.take differs from numpy")
    ms = _median_ms(lambda: torch.take(table, idx), 20, per=20)
    nbytes = 4 * GATHER_IDX * 2 + 4 * GATHER_TABLE
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"K2-K4 yardstick: torch.take of {GATHER_IDX} int64 indices into "
          f"a {GATHER_TABLE}-entry int32 table {ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms (bytes; {nbytes} B at 3.35 TB/s), "
          f"{bound_ms / ms:.3f} of the time")


def phase_small():
    """1 MB pan-genome: card against CPU, library and CLI."""
    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    records = pangenome_records(1, seed=PAN_SEED + 1)
    kw = dict(want_sa=True, want_rssa=True)
    t0 = time.perf_counter()
    gpu, _ = pfbwt_fused_records(records, ParserParams(w=W, p=P),
                                 device="cuda", **kw)
    t1 = time.perf_counter()
    cpu, _ = pfbwt_fused_records(records, ParserParams(w=W, p=P),
                                 device="cpu", **kw)
    t2 = time.perf_counter()
    for field in ("bwt", "sa", "ssa", "esa"):
        check(np.array_equal(getattr(gpu, field), getattr(cpu, field)),
              f"1 MB: {field} differs between cuda and cpu")
    check(gpu.nruns == cpu.nruns, "1 MB: run counts differ")
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "pan1mb.fa")
    write_fasta(fasta, records)
    prefix = os.path.join(out_dir, "pan1mb_cuda")
    rc = cli_main([fasta, "-o", prefix, "--fused", "-s", "-r"])
    check(rc == 0, f"CLI exit code {rc}")
    want = {
        "bwt": cpu.bwt.tobytes(),
        "sa": cpu.sa.astype("<u8").tobytes(),
        "ssa": cpu.ssa.astype("<u8").tobytes(),
        "esa": cpu.esa.astype("<u8").tobytes(),
    }
    for ext, data in want.items():
        with open(f"{prefix}.{ext}", "rb") as f:
            check(f.read() == data, f"CLI .{ext} differs from the CPU run")
    print(f"1 MB pan-genome: n={cpu.bwt.shape[0] - 1} r={cpu.nruns}; cuda "
          f"{t1 - t0:.2f} s and cpu {t2 - t1:.2f} s give identical "
          ".bwt/.sa/.ssa/.esa, library and CLI")


def phase_main(records, C):
    """The 64 MB pan-genome fused build with K1's count read around it."""
    import torch

    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    t0 = time.perf_counter()
    res, info = pfbwt_fused_records(
        records, ParserParams(w=W, p=P), device="cuda", want_sa=True,
        want_rssa=True,
    )
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"64 MB J2 seconds: {info['j2_s']:.4f} ({info['j2_runs']} run)")
    print(f"64 MB J3 seconds: {info['j3_s']:.4f}")
    timed = sum(info[k] for k in ("stream_s", "host_s", "j2_s", "j3_s",
                                  "fetch_s"))
    print(f"64 MB end-to-end seconds: {e2e:.4f} (records to stream "
          f"{info['stream_s']:.4f}, host input check {info['host_s']:.4f}, "
          f"download + sampling {info['fetch_s']:.4f}, untimed remainder "
          f"{e2e - timed:.4f})")
    print(f"64 MB peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"64 MB n={info['n']} r={info['r']} checksum={info['checksum']} "
          f"nphrases={info['nphrases']} D={info['D']} "
          f"dict_b={info['dict_b']} rounds={info['rounds']}")
    print(f"64 MB K1 launches: {launches}")
    check(launches >= 1, "the main path did not launch K1")
    t1 = time.perf_counter()
    check_bwt_sa(C, res.bwt, res.sa, "cuda")
    print(f"64 MB SA/BWT checks passed ({time.perf_counter() - t1:.2f} s)")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "pfbwtf_tpu_torch")):
        print("pfbwtf_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
    from pfbwtf_tpu_torch.ops.fused import _bucket
    from pfbwtf_tpu_torch.utils.tables import ntoa_codes

    smi = phase_environment()
    records = pangenome_records(64)
    C, _, _ = build_stream(records, ParserParams(w=W, p=P))
    n_b = _bucket(C.shape[0], 1 << 16)
    chars_p = np.full(n_b, ord("A"), dtype=np.uint8)
    chars_p[: C.shape[0]] = C
    codes_main = ntoa_codes(torch.from_numpy(chars_p).cuda())
    row = phase_k1(codes_main)
    del codes_main
    phase_gather_yardstick()
    phase_small()
    row["launches"] = phase_main(records, C)
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
