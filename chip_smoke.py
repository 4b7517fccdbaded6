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
2b. Kernel K5 (the carry scan of J3's running maxima and minima)
   against its plain versions on the card, bit for bit: max and min,
   forward and reverse, lengths around its 4,096-lane tile, views 8 bytes
   off a 16-byte boundary, values with -1 and the int64 extremes, and the
   fused posrank on grouped keys; then at the main path's shape (2^27
   int64) CUDA-event median times one launch at a time and in batches of
   20, the plain version's and torch.cummax's, the bytes bound and the
   share of it reached, and posrank's at the same shape.
3. Kernels K2-K4 (the TPU gather probe's table gathers) against their
   plain versions on the card, bit for bit, in both tiers (shared memory
   and L2): tables of 1, 1000 and 2^20 entries and the two around the
   tier boundary, each also as a view off 16 bytes, index lengths from 1
   to 1,000,003 around the 16-lane unroll, an index view one element past
   an allocation, out-of-range lanes for K3 (wrap, fill) and K4 (clip),
   and the probe's shape (2^20 table, 2^24 indices); there CUDA-event
   median times one launch at a time and in batches of 20, torch.take's
   in the same call, and the share of the bytes bound reached.  Then K2
   over a sweep of table sizes (2^10 to 2^24 entries, 2^24 indices) with
   each size's tier, and K2-K4 at J3's shape (2^21 entries, 75,497,472
   indices); then probes/gather_probe.main with the launch counts set to
   0 before it.
4. The whole fused build of a 1 MB pan-genome on the card against the
   same build on the CPU, through pfbwt_fused_records and through the
   CLI (``--fused -s -r``): .bwt/.sa/.ssa/.esa bytes must be identical.
5. The main path: the fused build of the 64 MB pan-genome of bench.py
   (8 mutated copies of an 8 MiB unit, SNP rate 0.001, w=10, p=100, seed
   4321) with the kernel launch counts set to 0 just before and read just
   after.  Stage times, peak device memory, n, r, checksum and doubling
   rounds are printed; the SA must be a permutation of [0, n] and every
   BWT char the one before its suffix; K5 must have launched once a dict
   doubling round and four times more (the first round, the word of each
   dict position, the next separator and the last emitter).
6. The streamed build (``--fused -m``) of the 1 MB pan-genome on the
   card, with the streamed J2 and many emission chunks, library and CLI:
   .bwt/.sa/.ssa/.esa must equal phase 4's CPU build.
7. The streamed build of the 64 MB input (streamed J2 in 5 chunks, 9
   emission chunks): its files must equal phase 5's, byte for byte.
   Also the monolithic J2's peak device memory per input byte, the figure
   behind fused_stream.J2_STREAM_ABOVE.
8. The staged build (pfbwt_f -s -r, no --fused) of the 1 MB pan-genome
   on the card against the CPU, through the library (run_parser +
   run_pfbwt) and the CLI: all eleven files (.dict .occ .parse .n
   .bwlast .ilist .bwsai .bwt .sa .ssa .esa) identical; the chunked
   parse in several chunks against the whole-array parse.  Then (phase
   8c) the same staged build with PFBWT_BACKEND=numpy, K1 on the card and
   the parse-BWT and the assembly on the host: the eleven files equal the
   card's; and simplebwt (the brute-force SA oracle) over the records each
   padded with w 'A's: its .bwt and .sa equal the staged build's.
9. The staged build of the 64 MB input: .bwt/.sa/.ssa/.esa equal phase
   5's, one K1 launch, stage seconds and peak device memory; then its
   stage 3 again on the card from its checkpoint files, with the emission
   forced onto the path it takes past 63 key bits (assemble_core with
   wide=True: the scatter fan-out and the stable two-key sort):
   .bwt/.sa/.ssa/.esa equal, seconds and peak printed; then
   --chunk-mb 16 on the same input: all eleven files equal the
   whole-array staged run's, one K1 launch per chunk.  Phase 9b,
   merge_pfp at full width: the 8 records as 4 FASTA shards of 2, three
   parsed on the card (--parse-only -s), the fourth given as a FASTA;
   merge_pfp -s --parse-bwt on the card launches K1 once, its seven files
   equal the staged build's checkpoint files, and --pfbwt-only -s -r on
   them gives its .bwt/.sa/.ssa/.esa; the merge's seconds by part and its
   peak device memory are printed.  Phase 9c: the resume of the staged
   build's checkpoint files with PFBWT_ASSEMBLE_BACKEND=numpy (stage 3 on
   the host): .bwt/.sa/.ssa/.esa equal the card's, assembly_s printed
   beside the card's.
   Between them (phase 8b), the staged -m build (-m -s -r: memory-mapped
   checkpoint files, the streamed final stage on the card) of the 1 MB
   input, card against CPU, library and CLI: the eleven files and the
   .gsa/.glcp workspace identical, .glcp present (the native LCP kernel
   ran).
10. The staged -m build of the 64 MB input: its eleven files equal phase
   9's; then, in a child process, a resume with --pfbwt-only -m -s -r from
   phase 9's checkpoint files: .bwt/.sa/.ssa/.esa equal phase 9's, with
   its emission chunks, stage seconds, peak device memory and peak host
   RSS printed; .gsa holds one entry per dict byte and .glcp exists.
11. vcf_to_bwt on a small panel (2 contigs of 20 kbp, 3 samples, the
   CLI's --wsize 10 --mod 10): card against CPU for staged -s -r -m
   --keep_parse (all fourteen files) and --fused -s -r -m; --threads 2
   against the serial run; vcf_scan per haplotype + merge_mps + mps_to_ma
   (card and CPU) against the one-shot .mps and .ma; consensus -H 1 -x
   (marker window 1) against vcf_scan's FASTA and .mps of the same
   haplotype; dump_markers and readable_markers on the .ma, one line a run
   and one a position.
12. No phase: the port reads none of pfbwtf_tpu's engine variables, so
   there is nothing to run under them; the other phases keep their
   numbers.
13. The pod parse at 64 MB through the CLI: pfbwt_f -s -r --shards 4
   --workers 4 (spawn workers parse the shards on the host), then
   --workers 1: the eleven files equal phase 9's, one K1 launch in this
   process (the merge's rescan), the environment unchanged; the split,
   the shard parses, the merge's rebuild, scan and dedup, the parse-BWT,
   the assembly and the writes timed, with the peak device memory.
14. vcf_to_bwt at full width: a 4 MiB reference (contigs of 3 and 1 MiB,
   seed 4323) and 16 phased diploid samples (tests/vcf_gen.random_vcf:
   0.003 sites a base, alt frequency 0.25, 10 % indels), 33 haplotypes,
   about 138 M characters, at w=10, p=100 through the CLI: staged -s -r
   -m and --fused -s -r -m.  Both runs' .bwt/.sa/.ssa/.esa/.ma/.mps are
   identical, the SA and BWT hold on the text rebuilt from the scanned
   records, and the card's .ma equals the host permute's over the same
   .sa; scan, parse + BWT and SA->MA seconds, peak device memory, n, r and
   marker runs are printed.
16. The mesh family on the card (after 14, before 15), as one one-rank
   NCCL world made in this process and destroyed at the end, every CLI
   call inside running on it: at 1 MB pfbwt_f --fused --mesh, --fused -m
   --mesh and --mesh (-s -r) give phases 4's and 8's files; at 64 MB
   --fused --mesh gives phase 5's .bwt/.sa/.ssa/.esa and --mesh phase 9's
   eleven files; vcf_to_bwt --mesh -s -r -m on the phase-14 panel gives
   its fused run's .bwt/.sa/.ssa/.esa/.ma/.mps.  Each build launches K1;
   the mesh parse's sizing and rows steps, the dict rank, the
   parse-BWT's doubling and ilist sort, the dict gSA doubling, the
   emission keys, the sort, decode and gather, the writes, the doubling
   rounds, the exchanges and the peak device memory are printed.
15. The full size of the streamed path: the 1 GiB pan-genome of
   benchmarks/stream_big.py (32 mutated copies of a 32 MiB unit, SNP rate
   0.001, seed 4321) in checksum-only mode with the default chunk target
   and the automatic J2 switch, which must choose the streamed J2; then
   K1 on all of its codes against the plain cut scan on a window across
   position 2**30 and on the last window.
Each build is driven with the kernel launch counts set to 0 just before
it and read just after, and must have launched K1; the gather probe must
have launched K2-K4.

Then one JSON line of kernel numbers, the nvidia-smi line, and last the
JSON result line.  Needs a CUDA card; without one it exits 2 and prints
no result.
"""

import json
import os
import subprocess
import sys
import time
from functools import partial
from unittest import mock

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
# the full size of the streamed path (benchmarks/stream_big.py:29-50)
BIG_MB, BIG_COPIES = 1024, 32
# K1 on the whole big input is held against the plain cut scan on two
# windows: one across this position, and the last one
K1_WINDOW, K1_ACROSS = 16 << 20, 1 << 30
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


def pangenome_records(size_mb: int, seed: int = PAN_SEED,
                      copies: int = PAN_COPIES):
    """bench.py's pan-genome input, in memory: ``copies`` mutated copies
    of one random ACGT unit, one record each (with 32 copies, the input of
    benchmarks/stream_big.py)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    unit = acgt[rng.integers(0, 4, size=(size_mb << 20) // copies)]
    records = []
    for i in range(copies):
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


K5_MAIN = 1 << 27  # int64 lanes: a dict doubling round of the main cell
K5_LENGTHS = (1, 2, 4095, 4096, 4097, 3 * 4096 + 7, 1_000_003)


def _k5_equal(got, want, what: str) -> int:
    import torch

    err = 0 if torch.equal(got, want) else 1
    check(err == 0, f"K5 differs from plain {what}")
    return err


def phase_k5():
    """K5 (the carry scan) against its plain versions on the card, bit for
    bit: both ops, forward and reverse, lengths around the 4,096-lane tile
    and 10^6 + 3, each also as a view 8 bytes off a 16-byte boundary,
    values with -1 and the int64 extremes; posrank on sorted keys in
    groups of 1 to 1000 under a random permutation.  Then the main path's
    shape (2^27 int64): bit-equal, CUDA-event median times one launch at a
    time and in batches of 20, the plain version's and torch.cummax's
    (the library yardstick), the bytes bound (16 B a lane at 3.35 TB/s)
    and its share of each time; posrank at the same shape beside its own
    bound (24 B a lane).  Returns the kernel's row."""
    import torch

    from pfbwtf_tpu_torch.ops import carry
    from pfbwtf_tpu_torch.ops.cuda import carry_scan as k5

    check(k5.tile_lanes() == 4096, f"K5 tile {k5.tile_lanes()} != 4096")
    gen = torch.Generator().manual_seed(15)
    max_err = runs = 0
    for n in K5_LENGTHS:
        buf = torch.randint(-(1 << 40), 1 << 40, (n + 1,), generator=gen)
        buf[::7] = -1
        buf[n // 2] = -(1 << 63)
        buf[n // 3] = (1 << 63) - 1
        buf = buf.cuda()
        for off in (0, 1):
            x = buf[off: off + n]
            for op in ("max", "min"):
                for rev in (False, True):
                    max_err |= _k5_equal(
                        k5.carry(x, op, rev), carry.carry_plain(x, op, rev),
                        f"at n={n} offset={off} op={op} reverse={rev}")
                    runs += 1
    rng = np.random.default_rng(15)
    for groups in (1, 3, 1000, 20000):
        sizes = rng.integers(1, 1001, size=groups)
        cks = torch.from_numpy(np.repeat(
            np.cumsum(rng.integers(1, 6, size=groups)), sizes)).cuda()
        order = torch.from_numpy(rng.permutation(cks.shape[0])).cuda()
        got, want = k5.posrank(cks, order), carry.posrank_plain(cks, order)
        for g, w in zip(got, want):
            max_err |= _k5_equal(g, w, f"posrank with {groups} groups")
        runs += 1
    torch.cuda.synchronize()
    print(f"K5 grid: lengths {K5_LENGTHS} x offsets (0, 1) x max/min x "
          f"forward/reverse and posrank on 4 groupings: {runs} runs "
          f"bit-equal to the plain versions")

    n = K5_MAIN
    x = torch.randint(-(1 << 40), 1 << 40, (n,), device="cuda")
    x[::7] = -1
    max_err |= _k5_equal(k5.carry(x, "max"), carry.carry_plain(x, "max"),
                         "at the main-path shape")
    max_err |= _k5_equal(k5.carry(x, "min", True),
                         carry.carry_plain(x, "min", True),
                         "at the main-path shape (min, reverse)")
    ms = _median_ms(lambda: k5.carry(x, "max"), 50)
    ms_batched = _median_ms(lambda: k5.carry(x, "max"), 20, per=20)
    plain_ms = _median_ms(lambda: carry.carry_plain(x, "max"), 5)
    library_ms = _median_ms(lambda: torch.cummax(x, 0), 5)
    bound_ms = 16 * n / HBM_BYTES_PER_S * 1e3
    print(f"K5 carry max at n={n}: bit-equal; {ms:.4f} ms one launch at a "
          f"time, {ms_batched:.4f} ms batched; plain {plain_ms:.3f} ms, "
          f"torch.cummax {library_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes, "
          f"16 B a lane at 3.35 TB/s), {bound_ms / ms:.3f} of the time one "
          f"at a time, {bound_ms / ms_batched:.3f} batched")
    del x
    cks = torch.sort(torch.randint(0, n // 4, (n,), device="cuda")).values
    order = torch.randperm(n, device="cuda")
    for g, w in zip(k5.posrank(cks, order), carry.posrank_plain(cks, order)):
        max_err |= _k5_equal(g, w, "posrank at the main-path shape")
    pos_ms = _median_ms(lambda: k5.posrank(cks, order), 20)
    pos_batched = _median_ms(lambda: k5.posrank(cks, order), 10, per=20)
    pos_plain = _median_ms(lambda: carry.posrank_plain(cks, order), 5)
    pos_bound = 24 * n / HBM_BYTES_PER_S * 1e3
    print(f"K5 posrank at n={n} (random permutation): bit-equal; "
          f"{pos_ms:.4f} ms one launch at a time, {pos_batched:.4f} ms "
          f"batched; plain {pos_plain:.3f} ms; bound {pos_bound:.4f} ms "
          f"(bytes, 24 B a lane), {pos_bound / pos_ms:.3f} of the time")
    del cks, order
    return {
        "name": "carry_scan", "route": "cuda",
        "source": "pfbwtf_tpu_torch/csrc/carry_scan.cu",
        "replaces": "none (lax.cummax / lax.cummin, XLA primitives)",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": library_ms, "bound_share": bound_ms / ms,
        "ms_batched": ms_batched, "bound_share_batched": bound_ms / ms_batched,
        "posrank": {"ms": pos_ms, "ms_batched": pos_batched,
                    "plain_ms": pos_plain, "bound_ms": pos_bound},
    }


GATHER_ROWS = (  # (wrapper, TPU kernel it replaces)
    ("take", "benchmarks/gather_probe.py:75"),
    ("take_along", "benchmarks/gather_probe.py:108"),
    ("take_rows", "benchmarks/gather_probe.py:145"),
)
GATHER_LENGTHS = (1, 3, 4, 5, 15, 16, 17, 63, 65, 8191, 1_000_003)
# the table-size sweep at 2^24 indices, in log2 entries; the last table
# of the shared-memory tier and the first past it join it on the card
GATHER_SWEEP_LOG2 = (10, 14, 15, 18, 20, 22, 24)
# J3's shape in the TPU probe's docstring (benchmarks/gather_probe.py:4-9):
# an m-scale table of 8 MiB and the 64 MB build's padded length n_b
J3_TABLE, J3_IDX = 1 << 21, 75_497_472


def _gather_bound_ms(t: int, n: int) -> float:
    """The bytes bound: n indices read and n outputs written (4 B each),
    the table read once, at 3.35 TB/s."""
    return (8 * n + 4 * t) / HBM_BYTES_PER_S * 1e3


def _gather_times(kern, table, idx, idx64) -> dict:
    """One launch at a time and batched, the kernel's and torch.take's,
    the tier that ran, and the bytes bound with the share of it each time
    reaches."""
    import torch

    from pfbwtf_tpu_torch.ops.cuda import gather as kernels

    before = dict(kernels.tier_launches)
    kern(table, idx)
    tier, = [k for k, v in kernels.tier_launches.items() if v > before[k]]
    t, n = table.shape[0], idx.shape[0]
    bound = _gather_bound_ms(t, n)
    r = {"T": t, "n": n, "tier": tier,
         "ms": _median_ms(lambda: kern(table, idx), 50),
         "ms_batched": _median_ms(lambda: kern(table, idx), 20, per=20),
         "take_ms": _median_ms(lambda: torch.take(table, idx64), 50),
         "take_ms_batched": _median_ms(lambda: torch.take(table, idx64), 20,
                                       per=20),
         "bound_ms": bound}
    r["bound_share"] = bound / r["ms"]
    r["bound_share_batched"] = bound / r["ms_batched"]
    return r


def _gather_line(label: str, r: dict) -> str:
    return (f"{label} T={r['T']} n={r['n']} ({r['tier']} tier): "
            f"{r['ms']:.4f} ms one launch at a time, {r['ms_batched']:.4f} "
            f"ms batched; torch.take {r['take_ms']:.4f} / "
            f"{r['take_ms_batched']:.4f} ms; bound {r['bound_ms']:.4f} ms "
            f"(bytes), {r['bound_share']:.3f} of the time one at a time, "
            f"{r['bound_share_batched']:.3f} batched")


def phase_gather():
    """K2-K4 against their plain versions on the card, bit for bit, in
    both tiers: tables of 1 and 1000 entries, the last of the
    shared-memory tier and the first past it, and 2^20, each also as a
    view off a 16-byte boundary; ragged index lengths around the 16-lane
    unroll, index views one element past an allocation and, for K3 and
    K4, out-of-range lanes.  Then the probe's shape (2^20 table, 2^24
    indices): bit-equal, times one at a time and batched beside
    torch.take's, the plain version's and the bound; the table-size sweep
    at 2^24 indices (K2 and torch.take, each size's tier) and J3's shape
    (T = 2^21, 75,497,472 indices, K2-K4 bit-equal and timed); last the
    probe itself (probes/gather_probe.main) with the launch counts set to
    0 just before and read just after.  Returns the kernels' rows."""
    import torch

    from pfbwtf_tpu_torch.ops import gather
    from pfbwtf_tpu_torch.ops.cuda import gather as kernels
    from pfbwtf_tpu_torch.probes import gather_probe

    def _int_err(got, want) -> int:
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    limit = kernels.smem_limit(torch.cuda.current_device())
    last_smem = limit // 4
    tables = (1, 1000, last_smem, last_smem + 1, GATHER_TABLE)
    print(f"K2-K4 shared-memory tier: tables up to {limit} B "
          f"({last_smem} entries) on this card")
    rng = np.random.default_rng(11)
    max_err = {name: 0 for name, _ in GATHER_ROWS}
    runs = 0
    tiers0 = dict(kernels.tier_launches)
    for t in tables:
        for toff in (0, 1, 2, 3):
            table = torch.from_numpy(rng.integers(
                -(1 << 31), (1 << 31) - 1, size=t + toff,
                dtype=np.int32)).cuda()[toff:]
            for n in GATHER_LENGTHS:
                for off in (0, 1):
                    for name, _ in GATHER_ROWS:
                        # K3 and K4 take every index: [-2T, 2T) has lanes
                        # that wrap, fill (K3) and clip (K4)
                        lo, hi = (0, t) if name == "take" else (-2 * t, 2 * t)
                        buf = torch.from_numpy(rng.integers(
                            lo, hi, size=n + off, dtype=np.int32)).cuda()
                        idx = buf[off:]
                        got = getattr(kernels, name)(table, idx)
                        want = getattr(gather, name + "_plain")(table, idx)
                        torch.cuda.synchronize()
                        err = _int_err(got, want)
                        max_err[name] = max(max_err[name], err)
                        check(err == 0, f"{name} differs from plain at T={t} "
                              f"table offset {toff} n={n} offset={off}")
                        runs += 1
    ran = {k: v - tiers0[k] for k, v in kernels.tier_launches.items()}
    check(ran["smem"] > 0 and ran["l2"] > 0,
          f"the grid did not run both tiers: {ran}")
    print(f"K2-K4 grid: tables {tables} x table offsets 0-3 x lengths "
          f"{GATHER_LENGTHS} x offsets (0, 1): {runs} runs bit-equal to the "
          f"plain versions, out-of-range lanes included for K3 and K4; "
          f"launches by tier {ran}")

    rng = np.random.default_rng(0)  # the probe's inputs
    table = torch.from_numpy(rng.integers(
        0, 1 << 30, size=GATHER_TABLE, dtype=np.int32)).cuda()
    idx = torch.from_numpy(rng.integers(
        0, GATHER_TABLE, size=GATHER_IDX, dtype=np.int32)).cuda()
    idx64 = idx.to(torch.int64)  # torch.take takes int64 indices only
    wild = torch.from_numpy(rng.integers(
        -2 * GATHER_TABLE, 2 * GATHER_TABLE, size=GATHER_IDX,
        dtype=np.int32)).cuda()
    rows = []
    for name, replaces in GATHER_ROWS:
        kern = getattr(kernels, name)
        plain = getattr(gather, name + "_plain")
        for what, ix in (("in-range", idx), ("[-2T, 2T)", wild)):
            if name == "take" and ix is wild:
                continue  # K2's indices are promised in range
            got, want = kern(table, ix), plain(table, ix)
            torch.cuda.synchronize()
            err = _int_err(got, want)
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} differs from plain at the probe's "
                  f"shape ({what} indices)")
        del got, want
        r = _gather_times(kern, table, idx, idx64)
        plain_ms = _median_ms(lambda: plain(table, idx), 10)
        print(_gather_line(f"{name} at the probe's shape, bit-equal;", r)
              + f"; plain {plain_ms:.4f} ms")
        rows.append({
            "name": name, "route": "cuda",
            "source": "pfbwtf_tpu_torch/csrc/gather.cu", "replaces": replaces,
            "launches": None, "max_abs_err": None, "ms": r["ms"],
            "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["take_ms"],
            "bound_share": r["bound_share"], "ms_batched": r["ms_batched"],
            "bound_share_batched": r["bound_share_batched"],
            "library_ms_batched": r["take_ms_batched"], "tier": r["tier"],
        })
    del table, idx, idx64, wild

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    sweep = []
    for t in sorted({1 << e for e in GATHER_SWEEP_LOG2}
                    | {last_smem, last_smem + 1}):
        table = torch.randint(0, 1 << 30, (t,), generator=gen,
                              device="cuda", dtype=torch.int32)
        idx = torch.randint(0, t, (GATHER_IDX,), generator=gen,
                            device="cuda", dtype=torch.int32)
        idx64 = idx.to(torch.int64)
        check(torch.equal(kernels.take(table, idx), torch.take(table, idx64)),
              f"take differs from torch.take at T={t}")
        r = _gather_times(kernels.take, table, idx, idx64)
        check(r["tier"] == ("smem" if t <= last_smem else "l2"),
              f"T={t} ran the {r['tier']} tier")
        print(_gather_line("take sweep, bit-equal to torch.take;", r))
        sweep.append(r)
        del table, idx, idx64
    rows[0]["sweep"] = sweep

    table = torch.randint(0, 1 << 30, (J3_TABLE,), generator=gen,
                          device="cuda", dtype=torch.int32)
    idx = torch.randint(0, J3_TABLE, (J3_IDX,), generator=gen,
                        device="cuda", dtype=torch.int32)
    wild = torch.randint(-2 * J3_TABLE, 2 * J3_TABLE, (J3_IDX,),
                         generator=gen, device="cuda", dtype=torch.int32)
    idx64 = idx.to(torch.int64)
    for row in rows:
        name = row["name"]
        kern = getattr(kernels, name)
        plain = getattr(gather, name + "_plain")
        for ix in ((idx,) if name == "take" else (idx, wild)):
            err = _int_err(kern(table, ix), plain(table, ix))
            max_err[name] = max(max_err[name], err)
            check(err == 0, f"{name} differs from plain at J3's shape")
        row["j3"] = r = _gather_times(kern, table, idx, idx64)
        print(_gather_line(f"{name} at J3's shape, bit-equal;", r))
    del table, idx, idx64, wild

    for row in rows:
        row["max_abs_err"] = max_err[row["name"]]
        kernels.launches[row["name"]] = 0
    res = gather_probe.main([], device="cuda")
    torch.cuda.synchronize()
    for row in rows:
        row["launches"] = kernels.launches[row["name"]]
        row["launches_by_path"] = {"gather probe": row["launches"]}
        check(row["launches"] >= 1, f"the gather probe did not launch "
              f"{row['name']}")
    check(all(ok for label, (_, ok) in res.items() if label != "torch.take"),
          "the gather probe's kernels do not match torch.take")
    print(f"gather probe launches: "
          f"{ {r['name']: r['launches'] for r in rows} }")
    return rows


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
    return records, cpu, fasta


def phase_main(records, C):
    """The 64 MB pan-genome fused build with the build's counters."""
    import torch

    from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, info = pfbwt_fused_records(
        records, ParserParams(w=W, p=P), device="cuda", want_sa=True,
        want_rssa=True,
    )
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = info["counts"].get("k1_launches", 0)
    k5_launches = info["counts"].get("k5_launches", 0)
    peak = torch.cuda.max_memory_allocated()
    print(f"64 MB J2 seconds: {info['j2_s']:.4f} ({info['j2_runs']} run)")
    print(f"64 MB J3 seconds: {info['j3_s']:.4f}")
    timed = sum(info[k] for k in ("stream_s", "host_s", "j2_s", "j3_s",
                                  "fetch_s"))
    print(f"64 MB end-to-end seconds: {e2e:.4f} (records to stream "
          f"{info['stream_s']:.4f}, host sizing {info['host_s']:.4f}, "
          f"download + sampling {info['fetch_s']:.4f}, untimed remainder "
          f"{e2e - timed:.4f})")
    print(f"64 MB peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"64 MB n={info['n']} r={info['r']} checksum={info['checksum']} "
          f"nphrases={info['nphrases']} D={info['D']} "
          f"dict_b={info['dict_b']} rounds={info['rounds']}")
    print(f"64 MB K1 launches: {launches}; the build's counts "
          f"{info['counts']}")
    check(launches >= 1, "the main path did not launch K1")
    dict_rounds = info["rounds"]["dict_sa"]
    print(f"64 MB K5 launches: {k5_launches} ({dict_rounds} dict rounds)")
    check(k5_launches == dict_rounds + 4,
          f"K5 launched {k5_launches} times, not dict rounds + 4")
    t1 = time.perf_counter()
    check_bwt_sa(C, res.bwt, res.sa, "cuda")
    print(f"64 MB SA/BWT checks passed ({time.perf_counter() - t1:.2f} s)")
    return (launches, k5_launches), res, peak


def fresh_memory():
    """Between phases: the cached blocks released, the peak reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def stream_build(C, **kw):
    """pfbwt_fused_stream on the card in file mode (in memory), with K1's
    count set to 0 just before and read just after.  Returns (files, out,
    info, launches, seconds, peak bytes)."""
    import io

    import torch

    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream

    fresh_memory()
    bwt_fp, sa_fp, info = io.BytesIO(), io.BytesIO(), {}
    k1.launches = 0
    t0 = time.perf_counter()
    out = pfbwt_fused_stream(C, W, P, bwt_fp=bwt_fp, sa_fp=sa_fp,
                             want_rssa=True, device="cuda", info=info, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = k1.launches
    check(launches >= 1, "the streamed build did not launch K1")
    files = {"bwt": bwt_fp.getvalue(), "sa": sa_fp.getvalue(),
             "ssa": out[3].tobytes(), "esa": out[4].tobytes()}
    return files, out, info, launches, secs, torch.cuda.max_memory_allocated()


def result_files(res):
    """The .bwt/.sa/.ssa/.esa bytes of a BWTResult, 64-bit widths."""
    return {"bwt": res.bwt.tobytes(), "sa": res.sa.astype("<u8").tobytes(),
            "ssa": res.ssa.astype("<u8").tobytes(),
            "esa": res.esa.astype("<u8").tobytes()}


def stage_line(info) -> str:
    """The stage seconds and chunking of a streamed build's ``info``."""
    j2 = "streamed" if info["j2_stream"] else "monolithic"
    return (f"J2 {info['j2_s']:.4f} s ({j2}, {info['j2_runs']} run), "
            f"J3a {info['j3a_s']:.4f} s, "
            f"{info['n_chunks']} emission chunks of chunk_b="
            f"{info['chunk_b']} {info['chunks_s']:.4f} s")


def phase_stream_small(records, cpu, fasta):
    """The 1 MB pan-genome streamed on the card, many chunks and the
    streamed J2, library and CLI, against the monolithic CPU build."""
    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream

    C, _, _ = build_stream(records, ParserParams(w=W, p=P))
    files, out, info, launches, secs, _ = stream_build(
        C, chunk_target=1 << 16, j2_stream=True, j2_chunk=1 << 18)
    want = result_files(cpu)
    for ext, data in want.items():
        check(files[ext] == data, f"1 MB streamed: .{ext} differs from the "
              "monolithic CPU build")
    check(out[0] == cpu.nruns, "1 MB streamed: run counts differ")
    check(info["n_chunks"] >= 8, "1 MB streamed: too few chunks")
    prefix = os.path.join(os.path.dirname(fasta), "pan1mb_cuda_stream")
    rc = cli_main([fasta, "-o", prefix, "--fused", "-m", "-s", "-r"])
    check(rc == 0, f"CLI -m exit code {rc}")
    for ext, data in want.items():
        with open(f"{prefix}.{ext}", "rb") as f:
            check(f.read() == data, f"CLI -m .{ext} differs from the CPU run")
    print(f"1 MB streamed build: {secs:.2f} s, {stage_line(info)}, K1 "
          f"launches {launches}; .bwt/.sa/.ssa/.esa equal the monolithic CPU "
          "build, library and CLI (--fused -m -s -r)")
    return launches


def phase_stream_main(C, mono_res, mono_peak):
    """The 64 MB input streamed (streamed J2, about 8 emission chunks)
    against phase_main's result, and the monolithic J2's own peak."""
    import torch

    from pfbwtf_tpu_torch.ops import fused, fused_stream

    fresh_memory()
    C_len = C.shape[0]
    chars_p = np.full(fused._bucket(C_len, 1 << 16), ord("A"), np.uint8)
    chars_p[:C_len] = C
    chars = torch.from_numpy(chars_p).cuda()
    state = fused.run_parse(chars, C_len, W, P, fused._bucket(
        fused.speculative_nphrases(C_len, P)))
    torch.cuda.synchronize()
    j2_peak = torch.cuda.max_memory_allocated()
    del chars, state
    per_byte = j2_peak / C_len
    print(f"64 MB monolithic J2 peak device memory (upload included): "
          f"{j2_peak} bytes, {per_byte:.2f} B per input byte; at "
          f"{fused_stream.J2_MEMORY_SHARE} of 80e9 B that is "
          f"{fused_stream.J2_MEMORY_SHARE * 80e9 / per_byte:.0f} input bytes "
          f"(module switch J2_STREAM_ABOVE = {fused_stream.J2_STREAM_ABOVE}, "
          f"from {fused_stream.J2_BYTES_PER_INPUT_BYTE} B a byte)")
    check(per_byte <= fused_stream.J2_BYTES_PER_INPUT_BYTE,
          "the monolithic J2 takes more memory a byte than the J2 switch "
          "assumes")

    files, out, info, launches, secs, peak = stream_build(
        C, chunk_target=8 << 20, j2_stream=True, j2_chunk=16 << 20)
    for ext, data in result_files(mono_res).items():
        check(files[ext] == data, f"64 MB streamed: .{ext} differs from the "
              "monolithic build")
    check(out[0] == mono_res.nruns, "64 MB streamed: run counts differ")
    check(info["n_chunks"] >= 5, "64 MB streamed: too few emission chunks")
    print(f"64 MB streamed build: {secs:.4f} s end to end, "
          f"{stage_line(info)}")
    print(f"64 MB streamed peak device memory: {peak} bytes "
          f"({peak / 2**30:.2f} GiB); monolithic {mono_peak} bytes "
          f"({mono_peak / 2**30:.2f} GiB)")
    print(f"64 MB streamed K1 launches: {launches}; .bwt/.sa/.ssa/.esa equal "
          "the monolithic build byte for byte")
    return launches


ELEVEN = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai", "bwt",
          "sa", "ssa", "esa")
MMAP_EXTS = ("gsa", "glcp")  # the -m workspace: the dict gSA and its LCP
CHUNK_MB = 16


def read_files(prefix: str, exts=ELEVEN):
    out = {}
    for ext in exts:
        with open(f"{prefix}.{ext}", "rb") as f:
            out[ext] = f.read()
    return out


def remove_files(prefix: str, exts=ELEVEN + MMAP_EXTS):
    for ext in exts:
        if os.path.exists(f"{prefix}.{ext}"):
            os.remove(f"{prefix}.{ext}")


def staged_build(fasta: str, prefix: str, device: str = "cuda",
                 chunk: int = 0, mmap: bool = False):
    """The staged build with -s -r (and -m) through the library, as the
    CLI runs it (pipeline.run_parser, or run_parser_chunked for
    --chunk-mb, then run_pfbwt), with K1's count set to 0 just before and
    read just after.  Returns (n, info, launches, seconds, peak device
    bytes or None)."""
    import torch

    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.pipeline import (PfbwtConfig, run_parser,
                                           run_parser_chunked, run_pfbwt)

    if device == "cuda":
        fresh_memory()
    params = ParserParams(w=W, p=P, get_sai=True)
    info = {}
    k1.launches = 0
    t0 = time.perf_counter()
    if chunk:
        n = run_parser_chunked(fasta, prefix, params, chunk, device=device,
                               info=info)
    else:
        n = run_parser(fasta, prefix, params, device=device, info=info)
    run_pfbwt(PfbwtConfig(prefix=prefix, w=W, sa=True, rssa=True,
                          device=device, mmap=mmap), n, info)
    peak = None
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    return n, info, k1.launches, time.perf_counter() - t0, peak


def staged_line(info) -> str:
    keys = ("read_s", "stream_s", "scan_s", "dedup_s", "parse_bwt_s",
            "assembly_s", "layout_s", "chunks_s", "write_s")
    return ", ".join(f"{k} {info[k]:.4f}" for k in keys if k in info)


def phase_staged_small(fasta: str, cpu):
    """The staged build of the 1 MB pan-genome: card against CPU through
    the library and the card's CLI (-s -r), all eleven files; the .bwt,
    .sa, .ssa and .esa also equal phase 4's fused CPU build; then the
    chunked parse in several chunks against the whole-array parse."""
    import torch

    from pfbwtf_tpu_torch import engine
    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.ops.chunked import parse_fasta_chunked
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    out_dir = os.path.dirname(fasta)
    pre = {d: os.path.join(out_dir, f"pan1mb_staged_{d}")
           for d in ("cuda", "cpu", "cli")}
    _, info, launches, secs, _ = staged_build(fasta, pre["cuda"])
    check(launches == 1, f"staged 1 MB: {launches} K1 launches, not 1")
    _, _, _, cpu_secs, _ = staged_build(fasta, pre["cpu"], device="cpu")
    want = read_files(pre["cpu"])
    check(read_files(pre["cuda"]) == want,
          "staged 1 MB: the card's files differ from the CPU's")
    for ext, data in result_files(cpu).items():
        check(want[ext] == data, f"staged 1 MB: .{ext} differs from the "
              "fused build")
    rc = cli_main([fasta, "-o", pre["cli"], "-s", "-r"])
    check(rc == 0, f"staged CLI exit code {rc}")
    check(read_files(pre["cli"]) == want,
          "staged 1 MB: the CLI's files differ from the CPU's")
    print(f"1 MB staged build: cuda {secs:.2f} s ({staged_line(info)}), cpu "
          f"{cpu_secs:.2f} s; all eleven files identical, library and CLI "
          "(-s -r), and .bwt/.sa/.ssa/.esa equal the fused build")

    params = ParserParams(w=W, p=P, get_sai=True)
    whole = engine.parse_fasta(fasta, params, device="cuda")
    chunk = 1 << 18
    cinfo = {}
    k1.launches = 0
    got = parse_fasta_chunked(fasta, params, chunk=chunk, device="cuda",
                              info=cinfo)
    torch.cuda.synchronize()
    check(k1.launches == cinfo["n_chunks"] == -(-got.n // chunk),
          f"chunked 1 MB: {k1.launches} K1 launches for "
          f"{cinfo['n_chunks']} chunks")
    for f in ("dict_starts", "dict_lens", "occs", "parse_ranks", "last",
              "sai"):
        check(np.array_equal(getattr(got, f), getattr(whole, f)),
              f"chunked 1 MB: {f} differs from the whole-array parse")
    check(np.array_equal(got.dict_flat(), whole.dict_flat()),
          "chunked 1 MB: .dict differs from the whole-array parse")
    print(f"1 MB chunked parse: {cinfo['n_chunks']} chunks of {chunk} codes, "
          f"{k1.launches} K1 launches, equal to the whole-array parse")
    for prefix in pre.values():
        remove_files(prefix)
    return launches, want


class host_env:
    """The PFBWT_* variable ``name`` set to "numpy" inside the block (and
    removed after it), and the calls of the host stages counted in
    ``calls``: inside it the staged build runs stages 2 and/or 3 on the
    host, as ``name`` selects them (engine.py)."""

    def __init__(self, name: str):
        self.name, self.calls, self.originals = name, {}, []

    def __enter__(self):
        from pfbwtf_tpu_torch.ops import bwt, parse_bwt

        for mod, fn_name in ((parse_bwt, "bwt_of_parse"),
                             (bwt, "assemble_bwt")):
            fn = getattr(mod, fn_name)
            self.originals.append((mod, fn_name, fn))
            self.calls[fn_name] = 0

            def counted(*a, _fn=fn, _name=fn_name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, fn_name, counted)
        os.environ[self.name] = "numpy"
        return self

    def __exit__(self, *exc):
        os.environ.pop(self.name, None)
        for mod, fn_name, fn in self.originals:
            setattr(mod, fn_name, fn)
        return False


def phase_host_small(fasta: str, records, want):
    """Phase 8c: the staged build of the 1 MB pan-genome with
    PFBWT_BACKEND=numpy (K1 on the card, the parse-BWT and the assembly
    on the host): its eleven files equal phase 8's; then simplebwt (the
    brute-force oracle, host numpy) over the records each padded with w
    'A's: its .bwt and .sa equal phase 8's."""
    from pfbwtf_tpu_torch.cli import simplebwt

    out_dir = os.path.dirname(fasta)
    pre = os.path.join(out_dir, "pan1mb_host")
    with host_env("PFBWT_BACKEND") as env:
        _, info, launches, secs, peak = staged_build(fasta, pre)
    check(launches == 1, f"staged 1 MB, host stages: {launches} K1 "
          "launches, not 1")
    check(env.calls == {"bwt_of_parse": 1, "assemble_bwt": 1},
          f"staged 1 MB, host stages: host calls {env.calls}")
    check(read_files(pre) == want, "staged 1 MB with PFBWT_BACKEND=numpy: "
          "the files differ from the card's")
    print(f"1 MB staged build, PFBWT_BACKEND=numpy: {secs:.2f} s "
          f"({staged_line(info)}), K1 launches {launches}, host "
          f"bwt_of_parse and assemble_bwt once each, peak device memory "
          f"{peak} bytes; all eleven files equal the card's")
    remove_files(pre)

    padded = os.path.join(out_dir, "pan1mb_padded.fa")
    write_fasta(padded, [(name, np.concatenate(
        (seq, np.full(W, ord("A"), np.uint8)))) for name, seq in records])
    t0 = time.perf_counter()
    rc = simplebwt.main([padded, "-o", pre, "-s"])
    secs = time.perf_counter() - t0
    check(rc == 0, f"simplebwt exit code {rc}")
    got = read_files(pre, ("bwt", "sa"))
    check(got["bwt"] == want["bwt"], "simplebwt: .bwt differs from the "
          "staged build's")
    check(got["sa"] == want["sa"], "simplebwt: .sa differs from the staged "
          "build's")
    print(f"1 MB simplebwt (numpy prefix doubling over the whole text): "
          f"{secs:.2f} s; .bwt and .sa equal the staged build's")
    remove_files(pre, ("bwt", "sa"))
    os.remove(padded)
    return launches


def phase_staged_main(fasta: str, C_len: int, fused_files):
    """The staged build of the 64 MB input (-s -r): .bwt/.sa/.ssa/.esa
    equal the fused build's, one K1 launch, stage seconds and peak; then
    --chunk-mb 16 on the same input, all eleven files equal the
    whole-array staged run's, one K1 launch per chunk."""
    from pfbwtf_tpu_torch import native

    out_dir = os.path.dirname(fasta)
    whole_pre = os.path.join(out_dir, "pan64_staged")
    n, info, launches, secs, peak = staged_build(fasta, whole_pre)
    check(n == C_len, f"staged 64 MB: n={n}, the input has {C_len}")
    whole = read_files(whole_pre)
    for ext, data in fused_files.items():
        check(whole[ext] == data, f"staged 64 MB: .{ext} differs from the "
              "fused build")
    check(launches == 1, f"staged 64 MB: {launches} K1 launches, not 1")
    print(f"64 MB staged build: {secs:.4f} s end to end ({staged_line(info)})")
    print(f"64 MB staged dedup: rows of {info['dedup_ncols']} 8-byte columns, "
          f"{info['dedup_rows_bytes']} bytes; lexsort "
          f"{info['dedup_lexsort_s']:.4f} s ({info['dedup_ncols']} stable "
          "sorts)")
    print(f"64 MB staged peak device memory: {peak} bytes "
          f"({peak / 2**30:.2f} GiB); K1 launches {launches}; "
          ".bwt/.sa/.ssa/.esa equal the fused build")
    stage3_wide(whole_pre, whole, info["assembly_s"])

    chunk = CHUNK_MB << 20
    chunk_pre = os.path.join(out_dir, "pan64_chunked")
    _, cinfo, claunch, csecs, cpeak = staged_build(fasta, chunk_pre,
                                                   chunk=chunk)
    check(read_files(chunk_pre) == whole, f"--chunk-mb {CHUNK_MB}: the files "
          "differ from the whole-array staged build")
    n_chunks = -(-C_len // chunk)
    check(claunch == cinfo["n_chunks"] == n_chunks,
          f"--chunk-mb {CHUNK_MB}: {claunch} K1 launches for {n_chunks} "
          "chunks")
    print(f"64 MB --chunk-mb {CHUNK_MB}: {csecs:.4f} s end to end "
          f"({staged_line(cinfo)}); host dedup "
          f"{'native rank_substrings' if native.available() else 'numpy'}")
    print(f"64 MB --chunk-mb {CHUNK_MB}: {claunch} K1 launches = "
          f"ceil({C_len} / {chunk}) = {n_chunks} chunks, 0 re-scans (each "
          f"chunk compacted exactly); peak device memory {cpeak} bytes "
          f"({cpeak / 2**30:.2f} GiB); all eleven files equal the "
          "whole-array staged build")
    remove_files(chunk_pre)
    return launches, claunch, whole_pre, whole, info


def stage3_wide(whole_pre: str, whole, assembly_s: float):
    """Phase 9's stage 3 again on the card from its checkpoint files, with
    the emission forced onto the path it takes past 63 key bits
    (assemble_core(wide=True): the scatter fan-out, whose running max is
    K5, and the stable two-key (gid, j) sort).  .bwt/.sa/.ssa/.esa equal
    phase 9's."""
    import torch

    from pfbwtf_tpu_torch.io import formats
    from pfbwtf_tpu_torch.ops import bwt_dev

    arrays = (
        formats.read_uint(whole_pre + ".dict", np.uint8), W,
        formats.read_uint(whole_pre + ".occ", formats.U64).astype(np.int64),
        formats.read_uint(whole_pre + ".bwlast", np.uint8),
        formats.read_uint(whole_pre + ".ilist", formats.U64).astype(np.int64),
        formats.read_uint(whole_pre + ".bwsai", formats.U64),
        formats.read_n(whole_pre + ".n"),
    )
    fresh_memory()
    t0 = time.perf_counter()
    with mock.patch.object(bwt_dev, "assemble_core",
                           partial(bwt_dev.assemble_core, wide=True)):
        res = bwt_dev.assemble_bwt_dev(*arrays, want_sa=True,
                                       want_rssa=True, device="cuda")
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = result_files(res)
    check(all(got[k] == whole[k] for k in got), "64 MB stage 3, wide "
          "emission: .bwt/.sa/.ssa/.esa differ from the staged build's")
    print(f"64 MB stage 3 on the card, wide emission (scatter fan-out, "
          f"two-key sort): {secs:.4f} s (upload, download and run sampling "
          f"included; the default emission's assembly_s {assembly_s:.4f}); "
          f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); "
          ".bwt/.sa/.ssa/.esa equal the staged build's")


MERGED_EXTS = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai")
MERGE_SHARDS = 4


def phase_merge_main(fasta: str, whole_pre: str, whole):
    """Phase 9b: merge_pfp at full width.  The 64 MB input's 8 records as
    4 FASTA shards of 2 records; the first three parsed on the card
    (pfbwt_f --parse-only -s), the fourth given to merge_pfp as a FASTA.
    merge_pfp -s --parse-bwt on the card launches K1 once, and its
    .dict/.occ/.parse/.n/.bwlast/.ilist/.bwsai equal phase 9's checkpoint
    files; pfbwt_f --pfbwt-only -s -r on them gives phase 9's
    .bwt/.sa/.ssa/.esa."""
    import torch

    from pfbwtf_tpu_torch.cli.merge_pfp import main as merge_main
    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1

    out_dir = os.path.dirname(fasta)
    records = read_fasta_bytes(fasta)
    per = len(records) // MERGE_SHARDS
    args, shard_fastas = [], []
    t0 = time.perf_counter()
    for i in range(MERGE_SHARDS):
        shard = os.path.join(out_dir, f"pan64_shard{i}.fa")
        write_fasta(shard, records[i * per: (i + 1) * per])
        shard_fastas.append(shard)
        if i == MERGE_SHARDS - 1:
            args.append(shard)  # read by merge_pfp as a FASTA
            continue
        prefix = os.path.join(out_dir, f"pan64_shard{i}")
        rc = cli_main([shard, "-o", prefix, "-s", "--parse-only"])
        check(rc == 0, f"pfbwt_f --parse-only on shard {i}: exit code {rc}")
        args.append(prefix)
    del records
    print(f"64 MB merge input: {MERGE_SHARDS} shards of {per} records, "
          f"{MERGE_SHARDS - 1} parsed on the card (--parse-only -s) in "
          f"{time.perf_counter() - t0:.2f} s, the last given as a FASTA")

    merged = os.path.join(out_dir, "pan64_merged")
    fresh_memory()
    info = {}
    k1.launches = 0
    t0 = time.perf_counter()
    rc = merge_main([*args, "-o", merged, "-s", "--parse-bwt"], info=info)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"merge_pfp exit code {rc}")
    check(launches == 1, f"merge_pfp 64 MB: {launches} K1 launches, not 1")
    got = read_files(merged, MERGED_EXTS)
    for ext in MERGED_EXTS:
        check(got[ext] == whole[ext], f"merge_pfp 64 MB: .{ext} differs from "
              "the whole staged build's")
    print(f"64 MB merge_pfp -s --parse-bwt: {secs:.4f} s end to end (text "
          f"rebuild {info['rebuild_s']:.4f}, scan {info['scan_s']:.4f}, "
          f"dedup {info['dedup_s']:.4f}, parse-BWT "
          f"{info['parse_bwt_s']:.4f}, writes {info['write_s']:.4f} s); "
          f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); K1 "
          f"launches {launches}; {', '.join('.' + e for e in MERGED_EXTS)} "
          "equal the whole staged build's")

    t0 = time.perf_counter()
    rc = cli_main(["-o", merged, "--pfbwt-only", "-s", "-r"])
    check(rc == 0, f"pfbwt_f --pfbwt-only on the merge: exit code {rc}")
    got = read_files(merged, ("bwt", "sa", "ssa", "esa"))
    for ext, data in got.items():
        check(data == whole[ext], f"merge_pfp 64 MB: the resumed .{ext} "
              "differs from the whole staged build's")
    print(f"64 MB --pfbwt-only -s -r on the merge: "
          f"{time.perf_counter() - t0:.4f} s; .bwt/.sa/.ssa/.esa equal the "
          "whole staged build's")
    for i in range(MERGE_SHARDS - 1):
        remove_files(os.path.join(out_dir, f"pan64_shard{i}"))
    remove_files(merged)
    for shard in shard_fastas:
        os.remove(shard)
    return launches


POD_SHARDS = 4


def phase_pod_main(fasta: str, whole):
    """Phase 13: the pod parse at 64 MB through the CLI, pfbwt_f -s -r
    --shards 4 with --workers 4 (a spawn pool) and then --workers 1 (in
    this process): all eleven files equal phase 9's, one K1 launch in
    this process (the merge's rescan; the workers scan on the host), the
    environment unchanged; seconds by stage and peak device memory."""
    import torch

    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1

    out_dir = os.path.dirname(fasta)
    launches = {}
    for workers in (POD_SHARDS, 1):
        prefix = os.path.join(out_dir, f"pan64_pod{workers}")
        env = dict(os.environ)
        fresh_memory()
        info = {}
        k1.launches = 0
        t0 = time.perf_counter()
        rc = cli_main([fasta, "-o", prefix, "-s", "-r", "--shards",
                       str(POD_SHARDS), "--workers", str(workers)], info=info)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1n = k1.launches
        peak = torch.cuda.max_memory_allocated()
        label = f"64 MB --shards {POD_SHARDS} --workers {workers}"
        check(rc == 0, f"{label}: exit code {rc}")
        check(k1n == 1, f"{label}: {k1n} K1 launches in this process, not 1")
        check(dict(os.environ) == env, f"{label}: the environment changed")
        check(read_files(prefix) == whole,
              f"{label}: the eleven files differ from the staged build's")
        shard_s = ", ".join(f"{s:.4f}" for s in info["shard_s"])
        print(f"{label}: {secs:.4f} s end to end (split {info['split_s']:.4f},"
              f" shard parses {info['shards_s']:.4f} [each {shard_s}], merge "
              f"rebuild {info['rebuild_s']:.4f}, scan {info['scan_s']:.4f}, "
              f"dedup {info['dedup_s']:.4f}, parse-BWT "
              f"{info['parse_bwt_s']:.4f}, assembly {info['assembly_s']:.4f}, "
              f"writes {info['write_s']:.4f} s); peak device memory {peak} "
              f"bytes ({peak / 2**30:.2f} GiB); K1 launches in this process "
              f"{k1n}; the eleven files equal the staged build's")
        launches[label] = k1n
        remove_files(prefix)
        for i in range(POD_SHARDS):
            remove_files(f"{prefix}.shard{i}", ("dict", "occ", "parse", "n"))
            if os.path.exists(f"{prefix}.shard{i}.fa"):
                os.remove(f"{prefix}.shard{i}.fa")
    return launches


def phase_host_assembly_main(whole_pre: str, whole, dev_info):
    """Phase 9c: stage 3 on the host at full width, the resume of phase
    9's checkpoint files (--pfbwt-only -s -r through pipeline.run_pfbwt)
    with PFBWT_ASSEMBLE_BACKEND=numpy: native SA-IS over the dict, one
    lexsort over the n + 1 emissions.  Its .bwt/.sa/.ssa/.esa equal phase
    9's; its assembly_s is printed beside phase 9's on the card."""
    import torch

    from pfbwtf_tpu_torch.pipeline import PfbwtConfig, run_pfbwt

    fresh_memory()
    info = {}
    t0 = time.perf_counter()
    with host_env("PFBWT_ASSEMBLE_BACKEND") as env:
        run_pfbwt(PfbwtConfig(prefix=whole_pre, w=W, sa=True, rssa=True),
                  None, info)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(env.calls == {"bwt_of_parse": 0, "assemble_bwt": 1},
          f"host assembly 64 MB: host calls {env.calls}")
    got = read_files(whole_pre, ("bwt", "sa", "ssa", "esa"))
    for ext, data in got.items():
        check(data == whole[ext], f"host assembly 64 MB: .{ext} differs from "
              "the card's")
    print(f"64 MB stage 3 on the host (PFBWT_ASSEMBLE_BACKEND=numpy, "
          f"--pfbwt-only -s -r): {secs:.4f} s, assembly_s "
          f"{info['assembly_s']:.4f} (the card's, phase 9: "
          f"{dev_info['assembly_s']:.4f}), reads + writes "
          f"{info['write_s']:.4f} s; peak device memory {peak} bytes; "
          ".bwt/.sa/.ssa/.esa equal the card's")


def check_workspace(prefix: str, what: str):
    """The -m workspace: .gsa holds one 8-byte entry per .dict byte, and
    .glcp exists (the native LCP kernel ran, not the numpy fallback)."""
    dict_b = os.path.getsize(f"{prefix}.dict")
    check(os.path.getsize(f"{prefix}.gsa") == 8 * dict_b,
          f"{what}: .gsa does not hold one entry per dict byte")
    check(os.path.exists(f"{prefix}.glcp"),
          f"{what}: no .glcp (the native SA-IS + LCP kernel did not run)")
    return dict_b


def phase_mmap_small(fasta: str, cpu):
    """The staged -m build of the 1 MB pan-genome: card against CPU
    through the library, the eleven files and .gsa/.glcp identical, the
    .bwt/.sa/.ssa/.esa equal to phase 4's fused CPU build; then the CLI's
    -m -s -r on the card."""
    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main

    out_dir = os.path.dirname(fasta)
    pre = {d: os.path.join(out_dir, f"pan1mb_mmap_{d}")
           for d in ("cuda", "cpu", "cli")}
    _, info, launches, secs, peak = staged_build(fasta, pre["cuda"],
                                                 mmap=True)
    check(launches == 1, f"staged -m 1 MB: {launches} K1 launches, not 1")
    staged_build(fasta, pre["cpu"], device="cpu", mmap=True)
    exts = ELEVEN + MMAP_EXTS
    want = read_files(pre["cpu"], exts)
    check(read_files(pre["cuda"], exts) == want,
          "staged -m 1 MB: the card's files differ from the CPU's")
    for ext, data in result_files(cpu).items():
        check(want[ext] == data, f"staged -m 1 MB: .{ext} differs from the "
              "fused build")
    check_workspace(pre["cuda"], "staged -m 1 MB")
    rc = cli_main([fasta, "-o", pre["cli"], "-m", "-s", "-r"])
    check(rc == 0, f"staged -m CLI exit code {rc}")
    check(read_files(pre["cli"], exts) == want,
          "staged -m 1 MB: the CLI's files differ from the CPU's")
    print(f"1 MB staged -m build: cuda {secs:.2f} s ({staged_line(info)}), "
          f"{info['n_chunks']} emission chunks, peak {peak} bytes; the "
          "eleven files and .gsa/.glcp identical to the CPU run, library "
          "and CLI (-m -s -r)")
    for prefix in pre.values():
        remove_files(prefix)
    return launches


# run in a child process, so that its peak RSS is its own: the CLI's
# --pfbwt-only -m -s -r, with run_pfbwt's info collected on the way.  The
# resident set is sampled from /proc/self/statm every 5 ms by a thread:
# getrusage's ru_maxrss keeps the resident set of the parent, which the
# child shares between fork and exec, and some kernels' /proc has no VmHWM
_RESUME_CHILD = r"""
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from pfbwtf_tpu_torch.cli.pfbwt_f import main
def rss():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None
torch.zeros(1, device="cuda")  # the CUDA context, before the baseline
base, peak, done = rss(), [0], threading.Event()
def sample():
    while not done.is_set():
        r = rss()
        if r is None:
            peak[0] = None
            return
        peak[0] = max(peak[0], r)
        done.wait(0.005)
sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
info = {}
t0 = time.perf_counter()
rc = main(["-o", sys.argv[2], "--pfbwt-only", "-m", "-s", "-r"], info=info)
torch.cuda.synchronize()
done.set()
sampler.join()
info.update(rc=rc, seconds=time.perf_counter() - t0,
            peak=torch.cuda.max_memory_allocated(), rss=peak[0],
            rss_base=base)
print(json.dumps(info))
"""


def phase_mmap_main(fasta: str, whole_pre: str, whole):
    """The staged -m build of the 64 MB input: the whole build (stage 1
    launches K1) against phase 9's files, then a resume with --pfbwt-only
    -m -s -r from phase 9's checkpoint files in a child process: its
    .bwt/.sa/.ssa/.esa equal phase 9's, and its stage seconds, emission
    chunks, peak device memory and peak host RSS."""
    out_dir = os.path.dirname(fasta)
    mm_pre = os.path.join(out_dir, "pan64_mmap")
    n, info, launches, secs, peak = staged_build(fasta, mm_pre, mmap=True)
    check(launches == 1, f"staged -m 64 MB: {launches} K1 launches, not 1")
    check(read_files(mm_pre) == whole,
          "staged -m 64 MB: the eleven files differ from the staged build")
    dict_b = check_workspace(mm_pre, "staged -m 64 MB")
    print(f"64 MB staged -m build: {secs:.4f} s end to end "
          f"({staged_line(info)}), {info['n_chunks']} emission chunks, peak "
          f"device memory {peak} bytes ({peak / 2**30:.2f} GiB), K1 launches "
          f"{launches}; the eleven files equal the staged build, .gsa = "
          f"{dict_b} entries")
    remove_files(mm_pre)

    fresh_memory()
    proc = subprocess.run(
        [sys.executable, "-c", _RESUME_CHILD, HERE, whole_pre],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "staged -m resume: the child failed: "
          + proc.stderr[-2000:])
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(child["rc"] == 0, f"staged -m resume: CLI exit code {child['rc']}")
    rss = child["rss"]
    got = read_files(whole_pre, ("bwt", "sa", "ssa", "esa"))
    for ext, data in got.items():
        check(data == whole[ext], f"staged -m resume: .{ext} differs from "
              "the staged build")
    check_workspace(whole_pre, "staged -m resume")
    print(f"64 MB staged -m resume (--pfbwt-only -m -s -r, child process): "
          f"{child['seconds']:.4f} s, layout {child['layout_s']:.4f} s, "
          f"chunks + writes {child['chunks_s']:.4f} s, "
          f"{child['n_chunks']} emission chunks of up to 2^22 slots; peak "
          f"device memory {child['peak']} bytes "
          f"({child['peak'] / 2**30:.2f} GiB), peak host RSS "
          + (f"{rss} bytes ({rss / 2**30:.2f} GiB, sampled every 5 ms), "
             f"of which {child['rss_base']} bytes before the resume "
             "(interpreter, torch and the CUDA context)"
             if rss else "not measured (no /proc/self/statm)")
          + "; .bwt/.sa/.ssa/.esa equal the staged build")
    remove_files(whole_pre)
    return launches


# the vcf_to_bwt panel: the shape of a chromosome panel of 1000 Genomes
# (several contigs; phased diploid samples with SNPs and indels, as
# tests/vcf_gen.random_vcf makes them; markers), cut in contig length and
# sample count to twice the main path's text
PANEL_SEED = 4323
PANEL_CONTIGS = (("chrA", 3 << 20), ("chrB", 1 << 20))
PANEL_SAMPLES = 16
PANEL_SMALL_CONTIGS = (("chrA", 20_000), ("chrB", 20_000))
PANEL_SMALL_SAMPLES = 3
PANEL_VCF = dict(density=0.003, af=0.25, indel_frac=0.1, max_indel=6)
VCF_EXTS = ("bwt", "sa", "ssa", "esa", "ma", "mps", "dict", "occ", "parse",
            "n", "docs", "bwlast", "ilist", "bwsai")


def make_panel(out_dir: str, name: str, contigs, nsamples: int, seed: int):
    """A reference FASTA of random ACGT contigs (60-byte lines) and a
    phased VCF panel on it; returns (fasta, vcf, sample names)."""
    from tests.vcf_gen import random_vcf

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = [(c, acgt[rng.integers(0, 4, size=n)]) for c, n in contigs]
    fasta = os.path.join(out_dir, f"{name}.fa")
    with open(fasta, "wb") as f:
        for c, seq in seqs:
            f.write(b">" + c.encode() + b"\n")
            for i in range(0, seq.size, 60):
                f.write(seq[i: i + 60].tobytes() + b"\n")
    vcf = os.path.join(out_dir, f"{name}.vcf")
    samples = random_vcf(vcf, [(c, s.tobytes()) for c, s in seqs], rng,
                         nsamples=nsamples, **PANEL_VCF)
    return fasta, vcf, samples


def vcf_cli(args, device: str = "cuda"):
    """vcf_to_bwt's CLI, with K1's count set to 0 just before and read
    just after and the pipeline's stage seconds collected.  Returns (info,
    launches, seconds, peak device bytes or None)."""
    import torch

    from pfbwtf_tpu_torch.cli import vcf_to_bwt as cli
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1

    if device == "cuda":
        fresh_memory()
    info = {}
    run = cli.vcf_to_bwt
    cli.vcf_to_bwt = lambda cfg: run(cfg, info)
    k1.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main(args, device=device)
    finally:
        cli.vcf_to_bwt = run
    peak = None
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"vcf_to_bwt {' '.join(args[2:])}: exit code {rc}")
    return info, k1.launches, time.perf_counter() - t0, peak


def vcf_files(prefix: str):
    return read_files(prefix, [e for e in VCF_EXTS
                               if os.path.exists(f"{prefix}.{e}")])


def vcf_line(info) -> str:
    return (f"scan {info['scan_s']:.4f} s, parse + BWT {info['build_s']:.4f} "
            f"s, SA->MA {info['ma_s']:.4f} s (.mps index "
            f"{info['ma_index_s']:.4f}, permute {info['ma_permute_s']:.4f}, "
            f".ma write {info['ma_write_s']:.4f}); n={info['n']} "
            f"r={info['r']} marker runs={info['ma_runs']}")


def remove_prefix(prefix: str):
    """Every file of a vcf_to_bwt or vcf_scan run under ``prefix``."""
    d, base = os.path.split(prefix)
    for f in os.listdir(d):
        if f.startswith(base + "."):
            os.remove(os.path.join(d, f))


def phase_vcf_small(out_dir: str):
    """vcf_to_bwt on a small panel (2 contigs of 20 kbp, 3 samples, the
    CLI's --wsize 10 --mod 10): card against CPU, staged (-s -r -m
    --keep_parse, all fourteen files) and fused (--fused -s -r -m); the
    staged run with --threads 2 against the serial one; and the
    reference's process graph, vcf_scan per haplotype + merge_mps +
    mps_to_ma (card and CPU), against the one-shot .mps and .ma; then
    consensus -H 1 -x against vcf_scan's haplotype, and dump_markers and
    readable_markers on the .ma."""
    import contextlib
    import io

    from pfbwtf_tpu_torch.cli import (consensus, dump_markers, merge_mps,
                                      mps_to_ma, readable_markers, vcf_scan)
    from pfbwtf_tpu_torch.markers.mps import read_mps_runs

    fa, vcf, samples = make_panel(out_dir, "panel_small",
                                  PANEL_SMALL_CONTIGS, PANEL_SMALL_SAMPLES,
                                  PANEL_SEED + 1)
    pre = os.path.join(out_dir, "vs")
    launches = {}
    for mode, extra in (("staged", ["--keep_parse"]), ("fused", ["--fused"])):
        files = {}
        for device in ("cuda", "cpu"):
            info, launch, secs, _ = vcf_cli(
                [fa, vcf, "-o", f"{pre}_{mode}_{device}", "-s", "-r", "-m",
                 *extra], device)
            files[device] = vcf_files(f"{pre}_{mode}_{device}")
            if device == "cuda":
                launches[mode] = launch
                check(launch >= 1, f"vcf_to_bwt small {mode}: no K1 launch")
                line = f"{secs:.2f} s ({vcf_line(info)})"
        check(files["cuda"] == files["cpu"], f"vcf_to_bwt small {mode}: the "
              "card's files differ from the CPU's")
        check(len(files["cuda"]) == (14 if mode == "staged" else 6),
              f"vcf_to_bwt small {mode}: files missing")
        print(f"vcf_to_bwt small panel {mode}: cuda {line}, K1 launches "
              f"{launches[mode]}; {sorted(files['cuda'])} identical to the "
              "CPU run")
    staged = vcf_files(f"{pre}_staged_cuda")
    vcf_cli([fa, vcf, "-o", f"{pre}_threads", "-s", "-r", "-m",
             "--keep_parse", "--threads", "2"])
    check(vcf_files(f"{pre}_threads") == staged,
          "vcf_to_bwt small: --threads 2 differs from the serial run")

    scan = f"{pre}_scan"
    check(vcf_scan.main(["-f", fa, "-o", scan, "-r", "-m", vcf]) == 0,
          "vcf_scan -r failed")
    prefixes = [scan + ".ref"]
    for s in samples:
        for h in (0, 1):
            check(vcf_scan.main(["-f", fa, "-o", scan, "-S", s, "-H", str(h),
                                 "-m", vcf]) == 0, "vcf_scan failed")
            prefixes.append(f"{scan}.{s}.{h}")
    check(merge_mps.main([f"{pre}_graph.mps", *prefixes]) == 0,
          "merge_mps failed")
    check(read_files(f"{pre}_graph", ("mps",))["mps"] == staged["mps"],
          "merge_mps of the vcf_scan outputs differs from vcf_to_bwt's .mps")
    for device in ("cuda", "cpu"):
        rc = mps_to_ma.main([f"{pre}_graph.mps", f"{pre}_staged_cuda.sa",
                             "-o", f"{pre}_graph_{device}.ma"], device=device)
        check(rc == 0, f"mps_to_ma on {device}: exit code {rc}")
        check(read_files(f"{pre}_graph_{device}", ("ma",))["ma"]
              == staged["ma"], f"mps_to_ma on {device} differs from "
              "vcf_to_bwt's .ma")
    print(f"vcf_to_bwt small panel: --threads 2 equals the serial run; "
          f"vcf_scan x {len(prefixes)} + merge_mps + mps_to_ma (card and "
          "CPU) give vcf_to_bwt's .mps and .ma")

    # consensus -x with vcf_scan's marker window (-w 1): vcf_scan's FASTA
    # and .mps for the same haplotype
    cons = f"{pre}_consensus"
    rc = consensus.main([vcf, "-f", fa, "-s", samples[0], "-H", "1", "-x",
                         cons + ".mps", "-w", "1", "-o", cons + ".fa"])
    check(rc == 0, f"consensus exit code {rc}")
    for ext in ("fa", "mps"):
        check(read_files(cons, (ext,)) == read_files(
            f"{scan}.{samples[0]}.0", (ext,)), f"consensus -H 1 -x: .{ext} "
            "differs from vcf_scan's")
    ma = f"{pre}_staged_cuda.ma"
    starts, ends, _ = read_mps_runs(ma)
    npos = int((ends.astype(np.int64) - starts.astype(np.int64) + 1).sum())
    for tool, want_lines in ((dump_markers, len(starts)),
                             (readable_markers, npos)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main([ma])
        lines = buf.getvalue().count("\n")
        check(rc == 0 and lines == want_lines, f"{tool.__name__} on the .ma: "
              f"exit code {rc}, {lines} lines, not {want_lines}")
    print(f"consensus -s {samples[0]} -H 1 -x -w 1: FASTA and .mps equal "
          f"vcf_scan's; dump_markers on the .ma: {len(starts)} lines, one "
          f"a run; readable_markers: {npos} lines, one a position")
    for prefix in (f"{pre}_staged_cuda", f"{pre}_staged_cpu",
                   f"{pre}_fused_cuda", f"{pre}_fused_cpu", f"{pre}_threads",
                   scan, f"{pre}_graph", f"{pre}_graph_cuda",
                   f"{pre}_graph_cpu", cons):
        remove_prefix(prefix)
    remove_prefix(os.path.join(out_dir, "panel_small"))
    return launches


def phase_vcf_panel(out_dir: str):
    """vcf_to_bwt at full width: a 4 MiB reference (3 + 1 MiB contigs) and
    16 phased samples, 33 haplotypes, about 138 M characters of text, at
    the main path's w and p, through the CLI on the card: staged -s -r -m
    and --fused -s -r -m.  The two runs' .bwt/.sa/.ssa/.esa/.ma/.mps are
    identical; the SA and BWT hold on the text rebuilt from the scanned
    records; the card's .ma equals the host permute's over the same .sa."""
    import io

    from pfbwtf_tpu_torch.markers.ma import marker_array_from_sa
    from pfbwtf_tpu_torch.markers.mps import write_mps_runs
    from pfbwtf_tpu_torch.markers.rle_window import RleWindowArray
    from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
    from pfbwtf_tpu_torch.vcf.reader import merge_vcfs
    from pfbwtf_tpu_torch.vcf.scan_worker import scan_task

    t0 = time.perf_counter()
    fa, vcf, samples = make_panel(out_dir, "panel", PANEL_CONTIGS,
                                  PANEL_SAMPLES, PANEL_SEED)
    nsites = sum(1 for line in open(vcf) if not line.startswith("#"))
    print(f"panel: contigs {PANEL_CONTIGS}, {len(samples)} samples, "
          f"{nsites} VCF records, made in {time.perf_counter() - t0:.2f} s")
    pre = os.path.join(out_dir, "panel_out")
    launches, files = {}, {}
    for mode, extra in (("staged", []), ("fused", ["--fused"])):
        info, launch, secs, peak = vcf_cli(
            [fa, vcf, "-o", f"{pre}_{mode}", "-s", "-r", "-m", "--wsize",
             str(W), "--mod", str(P), *extra])
        check(launch >= 1, f"vcf_to_bwt {mode}: no K1 launch")
        launches[mode] = launch
        files[mode] = read_files(f"{pre}_{mode}",
                                 ("bwt", "sa", "ssa", "esa", "ma", "mps"))
        print(f"vcf_to_bwt panel {mode}: {secs:.4f} s end to end "
              f"({vcf_line(info)}), peak device memory {peak} bytes "
              f"({peak / 2**30:.2f} GiB), K1 launches {launch}")
    check(files["staged"] == files["fused"], "vcf_to_bwt panel: the staged "
          "and fused runs' files differ")
    bwt = np.frombuffer(bytearray(files["staged"]["bwt"]), dtype=np.uint8)
    sa = np.frombuffer(files["staged"]["sa"], dtype=np.uint64)
    fused_files = files["fused"]
    del files

    t1 = time.perf_counter()
    vcfr = merge_vcfs([vcf])
    scan_args = {"fasta": fa, "w": W, "ma_wsize": 1, "want_markers": False}
    tasks = [("", 0, True)] + [(s, h, False) for s in samples for h in (0, 1)]
    records = [rec for task in tasks
               for rec in scan_task(vcfr, scan_args, task).records]
    C, _, _ = build_stream(records, ParserParams(w=W, p=P,
                                                 non_acgt_to_a=True))
    del records
    check_bwt_sa(C, bwt, sa, "cuda")
    print(f"vcf_to_bwt panel: {len(tasks)} haplotypes, n={C.shape[0]}; SA "
          f"and BWT checks passed on the text rebuilt from the scanned "
          f"records ({time.perf_counter() - t1:.2f} s)")
    del C, bwt

    t2 = time.perf_counter()
    runs = marker_array_from_sa(sa.view(np.int64),
                                RleWindowArray(f"{pre}_staged.mps"))
    host_s = time.perf_counter() - t2
    buf = io.BytesIO()
    write_mps_runs(buf, *runs)
    with open(f"{pre}_staged.ma", "rb") as f:
        check(buf.getvalue() == f.read(), "vcf_to_bwt panel: the card's .ma "
              "differs from the host permute's")
    print(f"vcf_to_bwt panel: the card's .ma ({len(runs[2])} runs) equals "
          f"markers/ma.marker_array_from_sa on the host ({host_s:.2f} s)")
    for prefix in (f"{pre}_staged", f"{pre}_fused"):
        remove_prefix(prefix)
    # phase 16 builds the same panel over the mesh, against these files
    return launches["staged"], launches["fused"], (fa, vcf, fused_files)


def mesh_line(info) -> str:
    """A mesh build's stage seconds, doubling rounds and exchanges."""
    keys = ("sizing_s", "rows_s", "rank_s", "bounds_s", "parse_sa_s",
            "ilist_s", "dict_sa_s", "layout_s", "emit_sort_s", "j3a_s",
            "keys_s", "sort_s", "decode_s", "gather_s", "fetch_s",
            "assembly_s", "write_s")
    st = info["mesh_stats"]
    return (", ".join(f"{k} {info[k]:.4f}" for k in keys if k in info)
            + f"; mesh doubling rounds {st['rounds']}, {st['exchanges']} "
            f"exchanges sending {st['rows_sent']} rows, stream fallbacks "
            f"{st['stream_fallbacks']}")


def mesh_cli(label: str, argv, want, exts):
    """pfbwt_f through the CLI (inside phase 16's world), with K1's count
    set to 0 just before and read just after; its files must equal
    ``want``.  Returns K1's launches."""
    import torch

    from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
    from pfbwtf_tpu_torch.ops import suffix
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1

    fresh_memory()
    info = {}
    suffix.rounds.update(parse_sa=0, dict_sa=0)
    k1.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(argv, info=info)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    prefix = argv[argv.index("-o") + 1]
    check(rc == 0, f"{label}: exit code {rc}")
    check(launches >= 1, f"{label}: no K1 launch")
    check(read_files(prefix, exts) == {e: want[e] for e in exts},
          f"{label}: the files differ")
    print(f"{label}: {secs:.4f} s end to end ({mesh_line(info)}; "
          f"single-device doubling rounds {dict(suffix.rounds)}); peak "
          f"device memory {peak} bytes ({peak / 2**30:.2f} GiB); K1 "
          f"launches {launches}; {len(exts)} files equal")
    remove_files(prefix, exts)
    return launches


def phase_mesh(fasta1: str, small_fused, small_staged, fasta64: str,
               fused64, staged64, panel):
    """Phase 16: the mesh family on the card as one one-rank NCCL world,
    made here and destroyed at the end; every CLI call inside runs on
    it.  1 MB: pfbwt_f --fused --mesh, --fused -m --mesh and --mesh (each
    -s -r) against phases 4 and 8; 64 MB: --fused --mesh against phase
    5's files and --mesh against phase 9's eleven; the phase-14 panel:
    vcf_to_bwt --mesh -s -r -m against its fused run's
    .bwt/.sa/.ssa/.esa/.ma/.mps.  Each build launches K1; stage seconds,
    doubling rounds, exchanges and peaks are printed."""
    import torch.distributed as dist

    from pfbwtf_tpu_torch.parallel.sharded import make_parse_mesh

    out_dir = os.path.dirname(fasta64)
    four = ("bwt", "sa", "ssa", "esa")
    launches = {}
    with make_parse_mesh("cuda") as mesh:
        check(mesh.owned and mesh.size == 1 and dist.get_backend() == "nccl",
              "phase 16 needs its own one-rank NCCL world")
        for label, extra, src, want, exts in (
                ("--fused --mesh 1 MB", ["--fused"], fasta1, small_fused,
                 four),
                ("--fused -m --mesh 1 MB", ["--fused", "-m"], fasta1,
                 small_fused, four),
                ("--mesh 1 MB", [], fasta1, small_staged, ELEVEN),
                ("--fused --mesh 64 MB", ["--fused"], fasta64, fused64,
                 four),
                ("--mesh 64 MB", [], fasta64, staged64, ELEVEN)):
            launches[label] = mesh_cli(
                label, [src, "-o", os.path.join(out_dir, "mesh"), "-s", "-r",
                        "--mesh", *extra], want, exts)
        fa, vcf, want = panel
        pre = os.path.join(out_dir, "panel_out_mesh")
        info, launch, secs, peak = vcf_cli(
            [fa, vcf, "-o", pre, "-s", "-r", "-m", "--wsize", str(W),
             "--mod", str(P), "--mesh"])
        check(launch >= 1, "vcf_to_bwt --mesh: no K1 launch")
        check(read_files(pre, tuple(want)) == want, "vcf_to_bwt --mesh: the "
              "files differ from the fused run's")
        print(f"vcf_to_bwt panel --mesh: {secs:.4f} s end to end "
              f"({vcf_line(info)}; {mesh_line(info)}); peak device memory "
              f"{peak} bytes ({peak / 2**30:.2f} GiB); K1 launches {launch};"
              " .bwt/.sa/.ssa/.esa/.ma/.mps equal the fused run's")
        launches["vcf_to_bwt --mesh"] = launch
        remove_prefix(pre)
    check(not dist.is_initialized(), "phase 16's world outlived it")
    remove_prefix(os.path.join(out_dir, "panel"))
    return launches


def phase_stream_big():
    """The streamed path at its full size: 1 GiB, checksum-only, default
    chunk target, automatic J2 switch; then K1 past position 2**30."""
    import torch

    from pfbwtf_tpu_torch.ops import fused
    from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
    from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream
    from pfbwtf_tpu_torch.ops.hash import mod_p, wang_hash, window_kmers
    from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
    from pfbwtf_tpu_torch.utils.tables import ntoa_codes

    t0 = time.perf_counter()
    records = pangenome_records(BIG_MB, copies=BIG_COPIES)
    C, _, _ = build_stream(records, ParserParams(w=W, p=P))
    del records
    n = C.shape[0]
    print(f"{BIG_MB} MB input: {BIG_COPIES} haplotypes, n={n}, made in "
          f"{time.perf_counter() - t0:.2f} s")
    fresh_memory()
    info = {}
    k1.launches = 0
    t0 = time.perf_counter()
    nruns, total, checksum = pfbwt_fused_stream(C, W, P, device="cuda",
                                                info=info)
    torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    check(nruns is None, "checksum-only mode fetched chunks")
    check(info["j2_stream"], "the automatic J2 switch chose the monolithic "
          f"J2 at {n} bytes")
    check(total == n + 1, f"total {total} != n + 1")
    check(launches >= 1, "the streamed build did not launch K1")
    timed = info["j2_s"] + info["j3a_s"] + info["chunks_s"]
    print(f"{BIG_MB} MB streamed build: {e2e:.4f} s end to end "
          f"({n / e2e / 1e6:.2f} MB/s), {stage_line(info)}, host input "
          f"check + padding {e2e - timed:.4f} s")
    print(f"{BIG_MB} MB peak device memory: {peak} bytes "
          f"({peak / 2**30:.2f} GiB); the peak so far as J2, J3a and the "
          f"chunks ended: {info['peak_j2']}, {info['peak_j3a']}, "
          f"{info['peak_chunks']} bytes")
    print(f"{BIG_MB} MB n={info['n']} n_b={info['n_b']} nphrases="
          f"{info['nphrases']} D={info['D']} dict_total={info['dict_total']} "
          f"n_levels={info['n_levels']} rounds={dict(fused.suffix.rounds)} "
          f"total={total} checksum={checksum} no bad lanes")
    print(f"{BIG_MB} MB K1 launches: {launches}")

    fresh_memory()
    chars_p = np.full(info["n_b"], ord("A"), np.uint8)
    chars_p[:n] = C
    del C
    codes = ntoa_codes(torch.from_numpy(chars_p).cuda())
    del chars_p
    flags = k1.cut_scan(codes, W, P)
    win = K1_WINDOW
    for lo in (K1_ACROSS - win // 2, info["n_b"] - win):
        seg = codes[lo - (W - 1): lo + win]
        plain = mod_p(wang_hash(window_kmers(seg, W)), P)[W - 1:] == 0
        check(torch.equal(flags[lo: lo + win], plain),
              f"K1 differs from plain on [{lo}, {lo + win})")
        print(f"K1 on all {info['n_b']} codes: bit-equal to the plain cut "
              f"scan on [{lo}, {lo + win}), {int(plain.sum())} cuts")
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
    from pfbwtf_tpu_torch.utils.malloc_tuning import tune_malloc
    from pfbwtf_tpu_torch.utils.tables import ntoa_codes

    # every phase runs under the allocator that the build CLIs set, so
    # host seconds compare across phases whatever their order
    tune_malloc()

    t_start = time.perf_counter()
    smi = phase_environment()
    records = pangenome_records(64)
    C, _, _ = build_stream(records, ParserParams(w=W, p=P))
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    fasta64 = os.path.join(out_dir, "pan64mb.fa")
    write_fasta(fasta64, records)
    n_b = _bucket(C.shape[0], 1 << 16)
    chars_p = np.full(n_b, ord("A"), dtype=np.uint8)
    chars_p[: C.shape[0]] = C
    codes_main = ntoa_codes(torch.from_numpy(chars_p).cuda())
    row = phase_k1(codes_main)
    del codes_main
    k5_row = phase_k5()
    gather_rows = phase_gather()
    small_records, small_cpu, small_fasta = phase_small()
    (row["launches"], k5_row["launches"]), mono_res, mono_peak = phase_main(
        records, C)
    del records
    by_path = {"fused 64 MB": row["launches"]}
    by_path["fused -m 1 MB"] = phase_stream_small(small_records, small_cpu,
                                                  small_fasta)
    by_path["fused -m 64 MB"] = phase_stream_main(C, mono_res, mono_peak)
    by_path["staged 1 MB"], small_want = phase_staged_small(small_fasta,
                                                            small_cpu)
    by_path["staged 1 MB, PFBWT_BACKEND=numpy"] = phase_host_small(
        small_fasta, small_records, small_want)
    by_path["staged -m 1 MB"] = phase_mmap_small(small_fasta, small_cpu)
    (by_path["staged 64 MB"], by_path[f"staged --chunk-mb {CHUNK_MB}"],
     whole_pre, whole, staged_info) = phase_staged_main(
         fasta64, C.shape[0], result_files(mono_res))
    by_path["merge_pfp 64 MB"] = phase_merge_main(fasta64, whole_pre, whole)
    phase_host_assembly_main(whole_pre, whole, staged_info)
    by_path.update(phase_pod_main(fasta64, whole))
    by_path["staged -m 64 MB"] = phase_mmap_main(fasta64, whole_pre, whole)
    fused64 = result_files(mono_res)
    del C, mono_res
    small = phase_vcf_small(out_dir)
    by_path["vcf_to_bwt small staged"] = small["staged"]
    by_path["vcf_to_bwt small fused"] = small["fused"]
    by_path["vcf_to_bwt staged"], by_path["vcf_to_bwt fused"], panel = (
        phase_vcf_panel(out_dir))
    by_path.update(phase_mesh(small_fasta, result_files(small_cpu),
                              small_want, fasta64, fused64, whole, panel))
    os.remove(fasta64)
    del fused64, whole, panel
    by_path[f"fused -m {BIG_MB} MB"] = phase_stream_big()
    row["launches_by_path"] = by_path
    print(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [row, k5_row, *gather_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
