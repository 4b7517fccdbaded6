"""The pod parse, ``pfbwt_f --shards N [--workers K]`` (the driver of
pfbwtf_tpu/parallel/driver.py, SURVEY.md §2.4).

Split the FASTA into record-aligned shards, parse every shard on its own
in a process pool, save each shard's parse checkpoint, then fold the
shards with the parse merge (parallel/merge.py) and save the merged
parse and its parse-BWT, ready for ``--pfbwt-only``.  Splitting at record
bounds is exact: every record ends with w pad 'A's, which reset the
rolling k-mer as the merge's junction rule expects.

A worker parses on the host, as pfbwtf_tpu's worker does: the plain cut
scan on a CPU tensor and the native host dedup, after tune_malloc as
the build CLIs call it, with its share of the host's cores as torch's
intra-op threads.  It never initialises CUDA, so the pool is ``spawn`` and the card stays the parent's, which
runs the merge's rescan (kernel K1), its dedup and the parse-BWT on
``device``.  Unlike pfbwtf_tpu's worker, it sets no environment variable
(that one does ``os.environ.setdefault("PFBWT_BACKEND", "numpy")``,
which with one worker runs in the parent and moves the parent's later
stages 2-3 to the host).
"""

import multiprocessing as mp
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

from ..io.fasta import read_fasta_bytes
from ..ops.parse import ParserParams
from ..pipeline import save_parse_bwt, save_parser
from .merge import merge_parse_prefixes


def split_fasta(fname: str, nshards: int, out_prefix: str) -> List[str]:
    """Split a FASTA into ``nshards`` record-aligned shard files
    ``<out_prefix>.shard<i>.fa``, records distributed contiguously with
    balanced bytes; returns the paths of the non-empty shards."""
    records = read_fasta_bytes(fname)
    if not records:
        raise ValueError(f"{fname}: no records")
    nshards = min(nshards, len(records))
    total = sum(s.shape[0] for _, s in records)
    target = total / nshards
    shards: List[List] = [[] for _ in range(nshards)]
    acc = 0
    si = 0
    for name, seq in records:
        if shards[si] and acc >= target * (si + 1) and si < nshards - 1:
            si += 1
        shards[si].append((name, seq))
        acc += seq.shape[0]
    paths = []
    for i, recs in enumerate(shards):
        path = f"{out_prefix}.shard{i}.fa"
        with open(path, "w") as f:
            for name, seq in recs:
                f.write(f">{name}\n{seq.tobytes().decode('ascii')}\n")
        paths.append(path)
    return [p for p, recs in zip(paths, shards) if recs]


def _parse_shard(path: str, prefix: str, params_kw: dict,
                 dtype_code: int) -> float:
    """One shard's parse on the host, saved at ``prefix``; returns its
    seconds."""
    from ..engine import parse_stream
    from ..io import formats
    from ..ops.parse import build_stream, finalize_parse

    t0 = time.perf_counter()
    params = ParserParams(**params_kw)
    records = read_fasta_bytes(path)
    C, doc_names, doc_starts = build_stream(records, params)
    starts, ends = parse_stream(C, params, device="cpu")
    res = finalize_parse(
        C, starts, ends, params,
        doc_names=doc_names if params.store_docs else [],
        doc_starts=doc_starts if params.store_docs else [],
        nseqs=len(records), device=None,
    )
    save_parser(res, prefix, formats.U32 if dtype_code == 32 else formats.U64)
    return time.perf_counter() - t0


def _parse_one(job):
    """A shard job (path, prefix, params_kw, dtype_code): malloc tuned as
    the build CLIs tune it, then the shard's parse.  Returns (prefix,
    seconds)."""
    from ..utils.malloc_tuning import tune_malloc

    tune_malloc()
    return job[1], _parse_shard(*job)


def _init_worker(threads: Optional[int]):
    import torch  # before the first job, so a job's seconds exclude it

    if threads:
        torch.set_num_threads(threads)


def run_shards(jobs: list, workers: Optional[int], threads: Optional[int]):
    """The shard jobs in ``workers`` spawn processes, each with
    ``threads`` intra-op threads (None: torch's default), or in this
    process when ``workers`` is at most 1.  Returns [(prefix, seconds)]
    in job order."""
    if not (workers and workers > 1):
        return [_parse_one(j) for j in jobs]
    # spawn, never fork: the parent may hold a CUDA context, which a
    # forked child cannot use
    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx,
                             initializer=_init_worker,
                             initargs=(threads,)) as ex:
        return list(ex.map(_parse_one, jobs))


def pod_parse(fname: str, output: str, params: ParserParams,
              nshards: int = 4, workers: Optional[int] = None, dtype=None,
              device="cuda", info: dict = None):
    """Split + shard parses in ``workers`` spawn processes (in this one
    when ``workers`` is at most 1) + the merge on ``device`` -> the merged
    parse checkpoint at ``output`` (.dict .occ .parse .n [.docs] .bwlast
    .ilist [.bwsai]); returns the merged ParseResult.  ``info`` receives
    split_s, shards_s (the pool, end to end) and shard_s (each shard's
    own seconds), the merge's keys (rebuild_s, scan_s, dedup_s) and
    save_parse_bwt's (parse_bwt_s, write_s, the merged parse's writes
    included)."""
    from .. import native
    from ..io import formats
    from ..utils.device import resolve_device

    resolve_device(device)  # no card: raise before any shard is parsed
    info = {} if info is None else info
    dtype = dtype if dtype is not None else formats.U64
    t0 = time.perf_counter()
    shard_paths = split_fasta(fname, nshards, output)
    params_kw = dict(
        w=params.w, p=params.p, get_sai=params.get_sai,
        store_docs=params.store_docs, non_acgt_to_a=params.non_acgt_to_a,
    )
    dtype_code = 32 if dtype == formats.U32 else 64
    jobs = [(path, f"{output}.shard{i}", params_kw, dtype_code)
            for i, path in enumerate(shard_paths)]
    t1 = time.perf_counter()
    native.available()  # build the host dedup's library once, here
    # a worker's share of the cores: torch's default, every core in each
    # worker, oversubscribes the host (scripts/pod_pool_probe.py)
    threads = max(1, len(os.sched_getaffinity(0)) // max(workers or 1, 1))
    done = run_shards(jobs, workers, threads)
    t2 = time.perf_counter()
    info.update(split_s=t1 - t0, shards_s=t2 - t1,
                shard_s=[s for _, s in done])
    merged = merge_parse_prefixes([p for p, _ in done], params,
                                  device=device, info=info)
    t3 = time.perf_counter()
    save_parser(merged, output, dtype)
    info["write_s"] = info.get("write_s", 0.0) + time.perf_counter() - t3
    save_parse_bwt(merged, output, dtype, sa=params.get_sai, device=device,
                   info=info)
    return merged
