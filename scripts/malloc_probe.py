#!/usr/bin/env python3
"""Does glibc malloc tuning move the port's host stages?

    python scripts/malloc_probe.py [--mb 64] [--reps 3] [--device cuda]

``pfbwtf_tpu`` calls ``utils/malloc_tuning.tune_malloc`` when it is
imported: it raises glibc's mmap and trim thresholds to 1 GiB, so that
numpy's large temporaries reuse the heap instead of fresh mappings.  The
port's import changes no global setting, so the call could only be an
explicit one in its CLI entry points.  This script measures whether that
would pay: it runs child processes in turn, ``plain`` and ``tuned``
(tune_malloc() called first), ``--reps`` times each.  Every child times

- the staged build (-s -r) of bench.py's pan-genome (chip_smoke's
  input, ``--mb`` MB) through pipeline.run_parser and run_pfbwt on
  ``--device``: its host stages read_s, stream_s and write_s, and its
  end-to-end seconds;
- the pod parse's shard parses (4 shards, in the child itself, as
  ``--workers 1`` runs them: the host cut scan and the host dedup).

One JSON line a child, then one summary line: per variant the median,
min and max of each time.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("read_s", "stream_s", "write_s", "staged_s", "shards_s")


def child(variant: str, fasta: str, out_dir: str, device: str) -> dict:
    tuned = None
    if variant == "tuned":
        from pfbwtf_tpu_torch.utils.malloc_tuning import tune_malloc

        tuned = tune_malloc()
    import torch

    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.parallel import driver
    from pfbwtf_tpu_torch.pipeline import PfbwtConfig, run_parser, run_pfbwt

    torch.zeros(1, device=device)  # the CUDA context, before the clock
    params = ParserParams(w=10, p=100, get_sai=True)
    prefix = os.path.join(out_dir, f"staged_{variant}")
    info = {}
    t0 = time.perf_counter()
    n = run_parser(fasta, prefix, params, device=device, info=info)
    run_pfbwt(PfbwtConfig(prefix=prefix, w=10, sa=True, rssa=True,
                          device=device), n, info)
    staged_s = time.perf_counter() - t0
    shard_pre = os.path.join(out_dir, f"pod_{variant}")
    paths = driver.split_fasta(fasta, 4, shard_pre)
    kw = dict(w=10, p=100, get_sai=True, store_docs=False,
              non_acgt_to_a=False)
    t1 = time.perf_counter()
    shard_s = [driver._parse_shard(p, f"{shard_pre}.shard{i}", kw, 64)
               for i, p in enumerate(paths)]
    shards_s = time.perf_counter() - t1
    return dict(variant=variant, tune_malloc=tuned, read_s=info["read_s"],
                stream_s=info["stream_s"], write_s=info["write_s"],
                staged_s=staged_s, shards_s=shards_s, shard_s=shard_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", nargs=3, metavar=("VARIANT", "FASTA", "DIR"))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if args.child:
        print(json.dumps(child(*args.child, args.device)))
        return 0
    import chip_smoke

    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        fasta = os.path.join(d, "pan.fa")
        chip_smoke.write_fasta(fasta, chip_smoke.pangenome_records(args.mb))
        rows = []
        for _ in range(args.reps):
            for variant in ("plain", "tuned"):
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--device",
                     args.device, "--child", variant, fasta, d],
                    capture_output=True, text=True, timeout=900)
                if proc.returncode != 0:
                    print(proc.stderr[-3000:], file=sys.stderr)
                    return 1
                rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
                print(json.dumps(rows[-1]))
    summary = {}
    for variant in ("plain", "tuned"):
        got = [r for r in rows if r["variant"] == variant]
        summary[variant] = {
            k: {"median": sorted(r[k] for r in got)[len(got) // 2],
                "min": min(r[k] for r in got), "max": max(r[k] for r in got)}
            for k in KEYS}
    print(json.dumps({"mb": args.mb, "reps": args.reps, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
