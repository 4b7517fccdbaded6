"""Multi-process bring-up and the pod parse recipe on ``torch.distributed``
(pfbwtf_tpu/parallel/multihost.py).

The reference's "cluster" is a process pool on one machine feeding Unix
pipes (vcf_to_bwt.py:230-237).  Here every process is one rank of one
world, one device each:

* each rank parses its contiguous record range of the input and writes
  ``{output}.host{rank}`` (the w-pad junction identity makes the shard
  boundaries exact, pfparser.hpp:194-263); after a barrier rank 0 folds
  the shards with the exact merge (parallel/merge.py) and writes the
  merged checkpoint files (``multihost_parse``);
* or the dictionary union and rank run as the collective string
  sample-sort over every rank (``multihost_union_parse``,
  parallel/dict_union.rank_rows_blocks).

Run one process a card under torchrun, with ``output`` on storage that
every rank sees:

    torchrun --nproc-per-node N -m pfbwtf_tpu_torch.parallel.multihost \\
        input.fa -o /shared/out

or give the rendezvous yourself: ``--coordinator host:port
--num-processes N --process-id R`` (as the JAX package's flags, also read
from JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID).
"""

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.malloc_tuning import tune_malloc
from .sharded import WORLD_TIMEOUT, ParseMesh, all_gather_rows, \
    make_parse_mesh


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda"):
    """Join the world (idempotent).  The rendezvous comes from the
    arguments, else JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, else torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK; with none of them this is one process and no
    world is made.  The backend is nccl on a card, gloo for
    ``device="cpu"``.  Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    coordinator = coordinator or env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    if coordinator is None and env.get("MASTER_ADDR") and env.get(
            "MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None or num_processes is None:
        return 0, 1
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id or 0))
        kw["device_id"] = torch.device("cuda", local)
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id or 0, timeout=WORLD_TIMEOUT, **kw)
    return dist.get_rank(), dist.get_world_size()


def _world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _my_record_range(nrecords: int, pid: int, nprocs: int):
    per = -(-nrecords // nprocs)
    lo = min(pid * per, nrecords)
    return lo, min(lo + per, nrecords)


def multihost_parse(fasta: str, output: str, params, dtype=None,
                    barrier: bool = True, device="cuda"):
    """The SPMD pod parse: each rank parses its record range on
    ``device`` and writes ``{output}.host{rank}``; after a barrier rank 0
    folds the shards with the exact merge on ``device`` and writes the
    merged checkpoint files and the parse-BWT at ``output``.  Returns the
    merged ParseResult on rank 0, None on the other ranks."""
    from .. import engine
    from ..io import formats
    from ..io.fasta import read_fasta_bytes
    from ..pipeline import save_parse_bwt, save_parser
    from .merge import merge_parse_prefixes

    dtype = dtype if dtype is not None else formats.U64
    pid, nprocs = _world()
    records = read_fasta_bytes(fasta)
    lo, hi = _my_record_range(len(records), pid, nprocs)
    if hi > lo:
        res = engine.parse_records(records[lo:hi], params, device)
        save_parser(res, f"{output}.host{pid}", dtype)
    if barrier and nprocs > 1:
        dist.barrier()
    if pid != 0:
        return None
    prefixes = [f"{output}.host{i}" for i in range(nprocs)
                if _my_record_range(len(records), i, nprocs)[1]
                > _my_record_range(len(records), i, nprocs)[0]]
    merged = merge_parse_prefixes(prefixes, params, device)
    save_parser(merged, output, dtype)
    save_parse_bwt(merged, output, dtype, sa=params.get_sai, device=device)
    return merged


def global_mesh(device="cuda") -> ParseMesh:
    """The mesh over every rank of the world."""
    return make_parse_mesh(device)


def multihost_rank_rows(cols_local: np.ndarray, mesh: ParseMesh):
    """The cross-process collective phrase rank: each rank contributes
    its local uint64 chunk rows; the union and rank run as
    dict_union.rank_rows_blocks over every rank.  Returns (global row
    ids, ranks) covering every rank's rows, on every rank, and this
    rank's global row-id offset.  Rows narrower than the widest are
    padded with zero chunks (zero bytes past the phrase end), so equal
    phrases of different ranks stay equal rows."""
    from .dict_union import _flip, rank_rows_blocks

    N_local, ncols_local = cols_local.shape
    sizes = all_gather_rows(mesh, torch.tensor(
        [N_local, ncols_local], device=mesh.device)).cpu().numpy()
    ncols = int(sizes[:, 1].max(initial=1))
    offset = int(sizes[: mesh.rank, 0].sum())
    N = int(sizes[:, 0].sum())
    rows = np.zeros((N_local, ncols), dtype=np.uint64)
    rows[:, :ncols_local] = cols_local
    ranks, _ = rank_rows_blocks(
        mesh, torch.from_numpy(_flip(rows)).to(mesh.device),
        offset + torch.arange(N_local, device=mesh.device), N)
    return np.arange(N, dtype=np.int64), ranks, offset


def multihost_union_parse(fasta: str, output: str, params, dtype=None,
                          device="cuda"):
    """The SPMD parse whose dictionary union and rank is a collective
    over every rank rather than a fold on rank 0: every rank runs the
    cut scan of the whole stream on its device (K1 on a card; the input
    is local to every process), the phrase occurrences are split evenly
    over the ranks, and the collective string sort ranks them on each
    rank's device.  Rank 0 writes the checkpoint files and the
    parse-BWT and returns the ParseResult; the other ranks return
    None."""
    from ..engine import parse_stream
    from ..io import formats
    from ..io.fasta import read_fasta_bytes
    from ..ops.parse import ParseResult, _tprime, build_stream
    from ..pipeline import save_parse_bwt, save_parser
    from .dict_union import _dict_from_ranks, phrase_chunk_rows

    dtype = dtype if dtype is not None else formats.U64
    records = read_fasta_bytes(fasta)
    C, doc_names, doc_starts = build_stream(records, params)
    T = _tprime(C, params.w)
    mesh = global_mesh(device)
    with mesh:
        starts, ends = parse_stream(C, params, device=mesh.device)
        lo, hi = _my_record_range(starts.shape[0], mesh.rank, mesh.size)
        cols = phrase_chunk_rows(T, starts[lo:hi], ends[lo:hi])
        _, ranks, _ = multihost_rank_rows(cols, mesh)
        if mesh.rank != 0:
            return None
    dict_starts, dict_lens, occs, parse_ranks = _dict_from_ranks(
        T, starts, ends, ranks)
    res = ParseResult(
        params=params, text=T, dict_starts=dict_starts, dict_lens=dict_lens,
        occs=occs, parse_ranks=parse_ranks, last=T[ends - params.w],
        sai=ends.astype(np.uint64), doc_names=list(doc_names),
        doc_starts=list(doc_starts), pos=C.shape[0] + params.w,
        nseqs=len(records))
    save_parser(res, output, dtype)
    save_parse_bwt(res, output, dtype, sa=params.get_sai, device=device)
    return res


def main(argv=None, device="cuda"):
    """``python -m pfbwtf_tpu_torch.parallel.multihost in.fa -o out``, one
    process a rank; the parses and the merge on ``device``."""
    from ..ops.parse import ParserParams

    ap = argparse.ArgumentParser(prog="pfbwt-multihost")
    ap.add_argument("fasta")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-w", "--window-size", type=int, default=10, dest="w")
    ap.add_argument("-p", "--mod-val", type=int, default=100, dest="p")
    ap.add_argument("-s", "--sa", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    tune_malloc()  # as the build CLIs do (utils/malloc_tuning.py)
    made = not dist.is_initialized()
    pid, nprocs = init_distributed(args.coordinator, args.num_processes,
                                   args.process_id, device)
    made = made and dist.is_initialized()
    try:
        ndev = (torch.cuda.device_count() if resolve_device(device).type
                == "cuda" else 1)
        print(f"process {pid}/{nprocs} up; local devices: {ndev}",
              file=sys.stderr)
        params = ParserParams(w=args.w, p=args.p, get_sai=args.sa)
        multihost_parse(args.fasta, args.output, params, device=device)
    finally:
        if made:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
