"""pfbwt-f CLI of the port, flag-compatible with the reference binary
(src/pfbwt-f.cpp:102-182):

    python -m pfbwtf_tpu_torch.cli.pfbwt_f [options] <fasta>

Two builds run on the CUDA card:

- the staged build (the default; ``--device`` is accepted and changes
  nothing): parse, parse-BWT and final BWT with the reference's
  checkpoint files, ``--parse-only`` / ``--pfbwt-only`` to run one half,
  ``--shards N`` (N > 1) for the pod parse (N record-aligned shards
  parsed on the host by ``--workers K`` processes, K = N by default, and
  merged on the card), else ``--chunk-mb N`` for the bounded-memory
  parse, ``--print-docs``, and ``-m`` for the streamed bounded-memory
  final stage;
- the fused whole-pipeline build (``--fused``), with its streamed form
  (``--fused -m``) for inputs past the one-program memory ceiling.

``--mesh`` runs either build over the mesh (parallel/): staged, the
mesh parse and the parse-BWT's sorts as collectives, then stage 3's
sorts (never the streamed -m, as in pfbwtf_tpu); with ``--fused`` (and
``--fused -m``) the fused mesh build.  In one process that is a
one-rank world on the card; under ``torchrun --nproc-per-node N`` every
rank runs the CLI, rank 0 alone writes the files and the ``-c`` bytes,
and every rank returns the same exit code.

As in pfbwtf_tpu, ``--mesh`` comes before ``--shards``, which comes
before ``--chunk-mb``; ``--shards`` 0 or 1 and a ``--workers`` count
without ``--shards`` change nothing, and ``--fused`` ignores the staged
build's flags (``--chunk-mb``, ``--parse-only``, ``--pfbwt-only``,
``--print-docs``, ``--shards``, ``--workers``); ``--parse-only`` with
``--pfbwt-only`` exits 1 first.  ``--u32`` selects the 32-bit build's
file widths; the default is 64-bit.
"""

import argparse
import sys
import time
from contextlib import nullcontext

from ..io import formats
from ..ops.parse import ParserParams
from ..utils.errors import PfbwtError
from ..utils.malloc_tuning import tune_malloc


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="pfbwt-f",
        description="prefix-free parsing BWT for genomic data (PyTorch/CUDA)",
    )
    ap.add_argument("fasta", nargs="?", default="-")
    ap.add_argument("-o", "--output", default="")
    ap.add_argument("-s", "--sa", action="store_true",
                    help="output full suffix array to <prefix>.sa")
    ap.add_argument("-r", "--rssa", action="store_true",
                    help="output run-length sampled SA to .ssa/.esa")
    ap.add_argument("-w", "--window-size", type=int, default=10, dest="w")
    ap.add_argument("-p", "--mod-val", type=int, default=100, dest="p")
    ap.add_argument("-m", "--mmap", action="store_true",
                    help="streamed final stage: memory-mapped checkpoint "
                         "files, .bwt/.sa written chunk by chunk, .gsa/.glcp "
                         "workspace (with --fused: the streamed fused "
                         "build)")
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--pfbwt-only", action="store_true")
    ap.add_argument("--trim-non-acgt", action="store_true")
    ap.add_argument("--non-acgt-to-a", action="store_true")
    ap.add_argument("--print-docs", action="store_true")
    ap.add_argument("-c", "--stdout", default="", dest="stdout_ext",
                    help="output file ending <ext> goes to stdout (bwt, sa)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--u32", action="store_true",
                    help="32-bit integer file widths (reference pfbwt-f)")
    ap.add_argument("--chunk-mb", type=int, default=0,
                    help="bounded-memory parse: scan the text in chunks of "
                         "this many MiB (0 = whole-array)")
    ap.add_argument("--device", action="store_true",
                    help="every heavy stage on the card (always the case "
                         "here)")
    ap.add_argument("--fused", action="store_true",
                    help="whole-pipeline device run: chars -> .bwt/.sa with "
                         "no host hops between stages")
    ap.add_argument("--mesh", action="store_true",
                    help="the build over the mesh: one rank a card under "
                         "torchrun, a one-rank world otherwise")
    ap.add_argument("--shards", type=int, default=0,
                    help="pod-style parse: split into N shards, parse in "
                         "parallel on the host, merge on the card (0 = "
                         "single stream)")
    ap.add_argument("--workers", type=int, default=0,
                    help="process workers for --shards (default: shards)")
    return ap


def main(argv=None, device="cuda", info: dict = None):
    """The CLI; ``info``, where given, receives the staged build's stage
    seconds (those of pipeline.run_parser, parallel/driver.pod_parse, the
    chunked parse or the mesh parse, then of run_pfbwt) with its build's
    spans, counts and build_id (utils/timer.build), or the fused mesh
    build's, and with --mesh ``mesh_stats`` (ParseMesh.stats)."""
    args = build_argparser().parse_args(argv)
    print("==== Command line:", " ".join(sys.argv), file=sys.stderr)
    tune_malloc()  # numpy temporaries reuse the heap (malloc_tuning.py)
    if args.non_acgt_to_a and args.trim_non_acgt:
        print("cannot have both --non-acgt-to-a and --trim-non-acgt",
              file=sys.stderr)
        return 1
    if args.fasta == "-" and not args.output:
        print("if reading from stdin, need a prefix for output files (-o)",
              file=sys.stderr)
        return 1
    if args.parse_only and args.pfbwt_only:
        print("cannot simultaneously do parse_only and pfbwt_only",
              file=sys.stderr)
        return 1
    output = args.output or args.fasta
    dtype = formats.U32 if args.u32 else formats.U64
    try:
        if args.mesh:
            from ..parallel.sharded import make_parse_mesh

            with make_parse_mesh(device) as mesh:
                if info is not None:  # exchanges, rows sent, rounds
                    info["mesh_stats"] = mesh.stats
                if args.fused:
                    return _run_fused_mesh(args, output, dtype, mesh, info)
                return _run_staged(args, output, dtype, device, info, mesh)
        if args.fused:
            return _run_fused(args, output, dtype, device)
        return _run_staged(args, output, dtype, device, info)
    except PfbwtError as e:
        print(str(e), file=sys.stderr)
        return 1


def _run_staged(args, output: str, dtype, device, info=None,
                mesh=None) -> int:
    """The staged build (pipeline.py), one build (utils/timer.build) that
    run_parser and run_pfbwt join: stages 1 and 2 write the checkpoint
    files (the mesh parse with a ``mesh``, else the pod parse with
    --shards > 1, else the chunked or whole-array parse), stage 3 resumes
    from them (its sorts over the mesh with one)."""
    from ..utils.timer import build

    info = {} if info is None else info
    with build(info):
        return _staged_stages(args, output, dtype, device, info, mesh)


def _staged_stages(args, output: str, dtype, device, info, mesh) -> int:
    from ..pipeline import (PfbwtConfig, run_parser, run_parser_chunked,
                            run_pfbwt)

    n = None
    if not args.pfbwt_only:
        print("running parser...", file=sys.stderr)
        params = ParserParams(
            w=args.w,
            p=args.p,
            get_sai=args.sa or args.rssa,
            store_docs=args.print_docs,
            non_acgt_to_a=args.non_acgt_to_a,
            trim_non_acgt=args.trim_non_acgt,
            verbose=args.verbose,
        )
        if mesh is not None:
            n = _mesh_parse(args.fasta, output, params, dtype, mesh, info)
        elif args.shards > 1:
            from ..parallel.driver import pod_parse

            n = pod_parse(args.fasta, output, params, nshards=args.shards,
                          workers=args.workers or args.shards, dtype=dtype,
                          device=device, info=info).n
        elif args.chunk_mb > 0:
            n = run_parser_chunked(args.fasta, output, params,
                                   args.chunk_mb << 20, dtype, device, info)
        else:
            n = run_parser(args.fasta, output, params, dtype, device, info)
    if not args.parse_only:
        print("generating BWT using pfbwt algorithm...", file=sys.stderr)
        run_pfbwt(PfbwtConfig(
            prefix=output, w=args.w, sa=args.sa, rssa=args.rssa,
            verbose=args.verbose, dtype=dtype, stdout_ext=args.stdout_ext,
            device=device, mmap=args.mmap and mesh is None, mesh=mesh,
        ), n, info)
    return 0


def _mesh_parse(fasta: str, output: str, params, dtype, mesh, info) -> int:
    """Stages 1 and 2 over the mesh (parallel/dict_union, pfbwt_mesh),
    every rank; rank 0 writes the checkpoint files, and a barrier holds
    the other ranks until they exist.  The width checks run on every
    rank, so that every rank raises at the same point.  Returns n."""
    from ..io.fasta import read_fasta_bytes
    from ..parallel.dict_union import distributed_parse_records
    from ..parallel.pfbwt_mesh import mesh_parse_bwt
    from ..pipeline import save_parser, write_parse_bwt
    from ..utils.limits import check_phrase_count, check_text_width

    info = {} if info is None else info
    res = distributed_parse_records(read_fasta_bytes(fasta), params, mesh,
                                    info)
    check_text_width(res.n, dtype)
    check_phrase_count(res.parse_ranks.shape[0], dtype)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        save_parser(res, output, dtype)
    t1 = time.perf_counter()
    pb = mesh_parse_bwt(res.parse_ranks, res.last, res.sai, mesh,
                        get_sai=params.get_sai, info=info)
    t2 = time.perf_counter()
    if mesh.rank == 0:
        write_parse_bwt(pb, output, dtype, params.get_sai)
    mesh.barrier()
    info["write_s"] = t1 - t0 + time.perf_counter() - t2
    return res.n


def _run_fused_mesh(args, output: str, dtype, mesh, info=None) -> int:
    """The fused build over the mesh (parallel/fused_mesh.py), with or
    without -m: .bwt/.sa[/.ssa/.esa] written by rank 0 after the width
    check on every rank."""
    from ..io.fasta import read_fasta_bytes
    from ..parallel.fused_mesh import pfbwt_fused_mesh_records
    from ..utils.limits import check_text_width
    from ..utils.timer import task_timer

    info = {} if info is None else info
    params = ParserParams(
        w=args.w, p=args.p, non_acgt_to_a=args.non_acgt_to_a,
        verbose=args.verbose,
    )
    with task_timer("fused mesh pipeline (parse+pfbwt)"):
        res = pfbwt_fused_mesh_records(
            read_fasta_bytes(args.fasta), params, mesh, want_sa=args.sa,
            want_rssa=args.rssa, sa_dtype=dtype, info=info)
    check_text_width(info["n"], dtype)
    if mesh.rank != 0:
        return 0
    t0 = time.perf_counter()
    rc = _write_fused_outputs(args, output, dtype, res)
    info["write_s"] = time.perf_counter() - t0
    return rc


def _run_fused(args, output: str, dtype, device) -> int:
    """Whole-pipeline device run (ops/fused.py): .bwt/.sa[/.ssa/.esa].
    With -m the streamed build (ops/fused_stream.py) runs instead and the
    outputs leave the card chunk by chunk."""
    from ..io.fasta import read_fasta_bytes
    from ..ops.fused import pfbwt_fused_records
    from ..utils.timer import task_timer

    params = ParserParams(
        w=args.w, p=args.p, non_acgt_to_a=args.non_acgt_to_a,
        verbose=args.verbose,
    )
    if args.mmap:
        return _run_fused_stream(args, output, dtype, device, params)
    with task_timer("fused device pipeline (parse+pfbwt)"):
        res, _ = pfbwt_fused_records(
            read_fasta_bytes(args.fasta), params, device=device,
            want_sa=args.sa, want_rssa=args.rssa, sa_dtype=dtype,
        )
    return _write_fused_outputs(args, output, dtype, res)


def _open_out(args, output: str, ext: str):
    if args.stdout_ext == ext:
        return nullcontext(sys.stdout.buffer)
    return open(f"{output}.{ext}", "wb")


def _run_fused_stream(args, output: str, dtype, device, params) -> int:
    """The streamed build: .bwt/.sa written chunk by chunk, .ssa/.esa from
    the run-length bookkeeping across chunks, all opened by the entry once
    the text's width is checked."""
    from ..io.fasta import read_fasta_bytes
    from ..ops.fused_stream import pfbwt_fused_stream_records
    from ..utils.timer import task_timer

    def open_out(ext):
        if ext in ("bwt", "sa"):
            return _open_out(args, output, ext)
        return open(f"{output}.{ext}", "wb")

    records = read_fasta_bytes(args.fasta)
    with task_timer("fused device pipeline, streamed (parse+pfbwt)"):
        out, info = pfbwt_fused_stream_records(
            records, params, open_out=open_out, want_sa=args.sa,
            want_rssa=args.rssa, sa_dtype=dtype, device=device,
        )
    n, nruns = info["n"], out[0]
    print(f"n: {n}", file=sys.stderr)
    print(f"r: {nruns}", file=sys.stderr)
    print(f"n/r: {n / nruns:.3f}", file=sys.stderr)
    return 0


def _write_fused_outputs(args, output: str, dtype, res) -> int:
    from ..utils.limits import check_text_width

    n = res.bwt.shape[0] - 1
    check_text_width(n, dtype)
    bwt_fp = (
        sys.stdout.buffer if args.stdout_ext == "bwt"
        else open(output + ".bwt", "wb")
    )
    bwt_fp.write(res.bwt.tobytes())
    if bwt_fp is not sys.stdout.buffer:
        bwt_fp.close()
    if args.sa:
        sa_fp = (
            sys.stdout.buffer if args.stdout_ext == "sa"
            else open(output + ".sa", "wb")
        )
        sa_fp.write(res.sa.astype(dtype).tobytes())
        if sa_fp is not sys.stdout.buffer:
            sa_fp.close()
    if args.rssa:
        with open(output + ".ssa", "wb") as f:
            f.write(res.ssa.astype(dtype).tobytes())
        with open(output + ".esa", "wb") as f:
            f.write(res.esa.astype(dtype).tobytes())
    print(f"n: {n}", file=sys.stderr)
    print(f"r: {res.nruns}", file=sys.stderr)
    print(f"n/r: {n / res.nruns:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
