#!/usr/bin/env python3
"""Why is the pod parse's spawn pool slower than its in-process loop?

    python scripts/pod_pool_probe.py [--mb 64] [--shards 4] [--reps 2]

Splits bench.py's pan-genome (chip_smoke's input, ``--mb`` MB) into
``--shards`` shards as ``pfbwt_f --shards`` does, then parses them with
``parallel/driver.run_shards`` four ways, in turns (A B C D D C B A for
two reps):

- ``pool``: ``--shards`` spawn workers, each with torch's default number
  of intra-op threads (the pool as ``pod_parse`` ran it before it set a
  count);
- ``pool_set``: the same pool, each worker setting torch's default
  count itself (``torch.set_num_threads`` before its first job): this
  separates the thread pool's start from the thread count;
- ``pool_split``: the same pool, each worker with ``cores // workers``
  threads (cores from the process's CPU affinity);
- ``inproc``: the shards one after another in this process, as
  ``--workers 1`` runs them.

Each run prints one JSON line: the pool's seconds end to end
(``shards_s``: spawn, imports and parses) and each shard's own seconds
(``shard_s``, timed inside the worker after its imports).  The last line
holds the median, min and max of both for each variant.  The shard
parses run on the host and touch no card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke
    from pfbwtf_tpu_torch import native
    from pfbwtf_tpu_torch.parallel import driver
    from pfbwtf_tpu_torch.utils.malloc_tuning import tune_malloc

    tune_malloc()  # as the build CLIs do
    cores = len(os.sched_getaffinity(0))
    split = max(1, cores // args.shards)
    variants = {"pool": (args.shards, None),
                "pool_set": (args.shards, torch.get_num_threads()),
                "pool_split": (args.shards, split),
                "inproc": (1, None)}
    order = list(variants)
    order = order + order[::-1]
    order = (order * args.reps)[: len(variants) * args.reps]
    print(json.dumps({"cores": cores, "torch_threads": torch.get_num_threads(),
                      "split_threads": split, "order": order}))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        fasta = os.path.join(d, "pan.fa")
        chip_smoke.write_fasta(fasta, chip_smoke.pangenome_records(args.mb))
        paths = driver.split_fasta(fasta, args.shards, os.path.join(d, "pod"))
        kw = dict(w=10, p=100, get_sai=True, store_docs=False,
                  non_acgt_to_a=False)
        native.available()
        rows = []
        for r, name in enumerate(order):
            workers, threads = variants[name]
            jobs = [(p, os.path.join(d, f"{name}{r}.shard{i}"), kw, 64)
                    for i, p in enumerate(paths)]
            t0 = time.perf_counter()
            done = driver.run_shards(jobs, workers, threads)
            rows.append(dict(variant=name, workers=workers, threads=threads,
                             shards_s=time.perf_counter() - t0,
                             shard_s=[s for _, s in done]))
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for name in variants:
        got = [r for r in rows if r["variant"] == name]
        per = {"shards_s": [r["shards_s"] for r in got],
               "shard_s": [s for r in got for s in r["shard_s"]]}
        summary[name] = {k: {"median": sorted(v)[len(v) // 2],
                             "min": min(v), "max": max(v)}
                         for k, v in per.items()}
    print(json.dumps({"mb": args.mb, "shards": args.shards,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
