"""Staged build: parse -> parse-BWT -> final BWT (pfbwtf_tpu/pipeline.py).

The reference's checkpoint protocol (SURVEY.md §5.4): ``run_parser``
writes .dict/.occ/.parse/.n[/.docs] and .bwlast/.ilist[/.bwsai]
(pfbwt-f.cpp:209-245), and ``run_pfbwt`` resumes from exactly those files
(pfbwt-f.cpp:275-349), so the two stages can run in different processes
(--parse-only / --pfbwt-only), and either may be pfbwtf_tpu's.  Every
heavy stage runs on ``device``; a ``backend`` of ``"numpy"`` (or the
PFBWT_* variables, engine.py) moves the parse-BWT and the assembly to the
host.

``run_parser`` and ``run_pfbwt`` are entry points of a build
(utils/timer.build): called alone each is one, called inside an open
build (cli/pfbwt_f's staged run) each joins it.  Its spans, in order:
``staged.read``, ``staged.stream``, ``staged.scan``, ``staged.dedup``
(engine.py), ``staged.save_parse`` (.dict .occ .parse .n),
``staged.parse_bwt``, ``staged.save_parse_bwt`` (.bwlast .ilist .bwsai),
``staged.load`` (stage 3 reads the files back), ``staged.assemble`` (with
the device assembly's ``fetch``) and ``staged.write`` (.bwt .sa .ssa
.esa).  Counters: ``ckpt_bytes`` (checkpoint files written),
``out_bytes`` (outputs written) beside the host reads' ``syncs`` and
``d2h_bytes``.  ``info`` gets ``peak_parse`` and ``peak_assemble``, the
device's peak allocation as stages 1-2 and stage 3 end (None on the
CPU).
"""

import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import engine
from .constants import EXT
from .io import formats
from .ops.parse import ParseResult, ParserParams
from .utils.device import peak_allocated
from .utils.limits import check_phrase_count, check_text_width
from .utils.timer import build, count, span, task_timer

U32, U64 = formats.U32, formats.U64


def _count_ckpt(prefix: str, exts):
    """Add the sizes of the checkpoint files ``prefix.<ext>`` to the open
    build's ``ckpt_bytes``."""
    count("ckpt_bytes",
          sum(os.path.getsize(prefix + "." + ext) for ext in exts))


def save_parser(res: ParseResult, prefix: str, dtype=U64):
    """save_parser (pfbwt_io.hpp:234-249): .dict streamed in slabs from
    the flat dictionary view, .occ, .parse, .docs, .n, counted in
    ``ckpt_bytes``.  Guards the output width before narrowing
    (pfparser.hpp:326-331, 393-405)."""
    check_text_width(res.n, dtype)
    check_phrase_count(res.parse_ranks.shape[0], dtype)
    with open(prefix + "." + EXT.DICT, "wb") as f:
        for slab in res.iter_dict_chunks():
            f.write(slab.tobytes())
    formats.write_occ(prefix + "." + EXT.OCC, res.occs, dtype)
    formats.write_parse_ranks(prefix + "." + EXT.PARSE, res.parse_ranks)
    exts = [EXT.DICT, EXT.OCC, EXT.PARSE, EXT.N]
    if res.params.store_docs:
        formats.write_docs(prefix + "." + EXT.DOCS, res.doc_names,
                           res.doc_starts)
        exts.append(EXT.DOCS)
    formats.write_n(prefix + "." + EXT.N, res.n)
    _count_ckpt(prefix, exts)


def write_parse_bwt(pb, prefix: str, dtype=U64, sa: bool = True):
    """The parse-BWT's files .bwlast, .ilist and (with ``sa``) .bwsai
    (pfbwt_io.hpp:287-297), counted in ``ckpt_bytes``."""
    formats.write_u8(prefix + "." + EXT.BWLST, pb.bwlast)
    formats.write_uint(prefix + "." + EXT.ILIST, pb.ilist, dtype)
    exts = [EXT.BWLST, EXT.ILIST]
    if sa:
        formats.write_uint(prefix + "." + EXT.BWSAI, pb.bwsai, dtype)
        exts.append(EXT.BWSAI)
    _count_ckpt(prefix, exts)


def save_parse_bwt(res: ParseResult, prefix: str, dtype=U64, sa: bool = True,
                   device="cuda", info: dict = None,
                   backend: Optional[str] = None):
    """Stage 2 (span ``staged.parse_bwt``) and its files
    (``staged.save_parse_bwt``); ``info`` receives parse_bwt_s and the
    seconds of the writes (write_s, added to)."""
    info = {} if info is None else info
    with span("staged.parse_bwt") as stage:
        pb = engine.parse_bwt(res, get_sai=sa, device=device, backend=backend)
    with span("staged.save_parse_bwt") as write:
        write_parse_bwt(pb, prefix, dtype, sa)
    info["parse_bwt_s"] = stage.seconds
    info["write_s"] = info.get("write_s", 0.0) + write.seconds
    return pb


@dataclass
class PfbwtConfig:
    prefix: str
    w: int = 10
    sa: bool = False
    rssa: bool = False
    verbose: bool = False
    dtype: np.dtype = U64
    stdout_ext: str = ""  # '-c <ext>': route one output to stdout
    device: str = "cuda"
    backend: Optional[str] = None  # 'numpy': stage 3 on the host (engine.py)
    mmap: bool = False  # -m: memmap inputs + streamed bounded-memory stage 3
    # a parallel/sharded.ParseMesh: stage 3's sorts over the mesh, every
    # rank reading the files and rank 0 alone writing
    mesh: object = None


def run_parser(in_fname: str, output: str, params: ParserParams, dtype=U64,
               device="cuda", info: dict = None,
               backend: Optional[str] = None) -> int:
    """Stages 1 and 2: parse, write the checkpoint files; returns n.  A
    build (module docstring); ``info`` receives engine.parse_fasta's keys,
    parse_bwt_s, write_s and peak_parse."""
    info = {} if info is None else info
    with build(info):
        with task_timer("parsing input"):
            res = engine.parse_fasta(in_fname, params, device, info)
        with task_timer("finalizing parse, writing dict, occs, and ranks",
                        "staged.save_parse") as write:
            save_parser(res, output, dtype)
        info["write_s"] = write.seconds
        with task_timer("ranking and bwt-ing parse and processing "
                        "last-chars"):
            save_parse_bwt(res, output, dtype, sa=params.get_sai,
                           device=device, info=info, backend=backend)
        if params.trim_non_acgt:
            # the reference writes the (always empty) non-ACGT run table
            # when trimming is asked for (pfbwt-f.cpp:238-240; the trim
            # path is disabled upstream, pfparser.hpp:338-359)
            open(output + ".ntab", "wb").close()
        info["peak_parse"] = peak_allocated(device)
    return res.n


def run_parser_chunked(in_fname: str, output: str, params: ParserParams,
                       chunk: int, dtype=U64, device="cuda",
                       info: dict = None,
                       backend: Optional[str] = None) -> int:
    """Stages 1 and 2 with the bounded-memory parse (``--chunk-mb``): the
    cut scan in ``chunk``-code pieces on ``device``, the dedup on the
    host, then the files of run_parser; returns n.  ``info`` receives
    ops/chunked.parse_fasta_chunked's keys, parse_bwt_s and write_s."""
    from .ops.chunked import parse_fasta_chunked

    info = {} if info is None else info
    res = parse_fasta_chunked(in_fname, params, chunk=chunk, device=device,
                              info=info)
    with span("staged.save_parse") as write:
        save_parser(res, output, dtype)
    info["write_s"] = write.seconds
    save_parse_bwt(res, output, dtype, sa=params.get_sai, device=device,
                   info=info, backend=backend)
    return res.n


def _out_handle(cfg: PfbwtConfig, ext: str):
    if cfg.stdout_ext == ext:
        return sys.stdout.buffer
    return open(cfg.prefix + "." + ext, "wb")


def _write_out(cfg: PfbwtConfig, ext: str, data: np.ndarray):
    """Output ``ext`` (to stdout with ``-c ext``), counted in
    ``out_bytes``."""
    fp = _out_handle(cfg, ext)
    fp.write(data.tobytes())
    if fp is not sys.stdout.buffer:
        fp.close()
    count("out_bytes", data.nbytes)


def run_pfbwt(cfg: PfbwtConfig, n: Optional[int] = None, info: dict = None):
    """Stage 3: load the checkpoint files, assemble the final BWT on
    cfg.device (or on the host: cfg.backend, engine.assemble_bwt; or
    over cfg.mesh, parallel/pfbwt_mesh.mesh_assemble_bwt), write
    .bwt[/.sa][/.ssa/.esa].  A build (module docstring); ``info`` receives
    assembly_s (span ``staged.assemble``), the seconds of the reads and
    writes (write_s, added to: spans ``staged.load`` and
    ``staged.write``), peak_assemble, and mesh_assemble_bwt's keys; with
    cfg.mmap, _run_pfbwt_stream's keys instead."""
    info = {} if info is None else info
    with build(info):
        return _run_pfbwt(cfg, n, info)


def _run_pfbwt(cfg: PfbwtConfig, n: Optional[int], info: dict):
    prefix = cfg.prefix
    with span("staged.load") as load:
        if cfg.mmap:
            # -m mode: the inputs stay file-backed (file_wrappers.hpp MMap
            # role)
            def read(ext, dtype):
                return np.memmap(prefix + "." + ext, dtype=dtype, mode="r")
        else:
            def read(ext, dtype):
                return formats.read_uint(prefix + "." + ext, dtype)
        dict_flat = read(EXT.DICT, np.uint8)
        occs = read(EXT.OCC, cfg.dtype)
        bwlast = read(EXT.BWLST, np.uint8)
        ilist = read(EXT.ILIST, cfg.dtype)
        any_sa = cfg.sa or cfg.rssa
        bwsai = read(EXT.BWSAI, cfg.dtype) if any_sa else None
        if n is None:
            n = formats.read_n(prefix + "." + EXT.N)
    check_text_width(n, cfg.dtype)
    if cfg.mmap:
        return _run_pfbwt_stream(cfg, dict_flat, occs, bwlast, ilist, bwsai,
                                 n, info)
    with task_timer(
        "generating final BWT w/ full and/or run-length SA"
        if any_sa
        else "generating final BWT w/o SA", "staged.assemble"
    ) as stage:
        if cfg.mesh is not None:
            from .parallel.pfbwt_mesh import mesh_assemble_bwt

            res = mesh_assemble_bwt(
                dict_flat, cfg.w, occs.astype(np.int64), bwlast,
                ilist.astype(np.int64), bwsai, n, cfg.mesh,
                want_sa=cfg.sa, want_rssa=cfg.rssa, sa_dtype=cfg.dtype,
                info=info,
            )
        else:
            res = engine.assemble_bwt(
                dict_flat, cfg.w, occs.astype(np.int64), bwlast,
                ilist.astype(np.int64), bwsai, n,
                want_sa=cfg.sa, want_rssa=cfg.rssa, sa_dtype=cfg.dtype,
                device=cfg.device, backend=cfg.backend,
            )
    info.update(assembly_s=stage.seconds,
                peak_assemble=peak_allocated(cfg.device))
    if cfg.mesh is not None and cfg.mesh.rank != 0:
        return res
    with span("staged.write") as write:
        _write_out(cfg, EXT.BWT, res.bwt)
        if cfg.sa:
            _write_out(cfg, EXT.SA, res.sa.astype(cfg.dtype))
        _finish(cfg, n, res.nruns, res.ssa, res.esa)
    info["write_s"] = (info.get("write_s", 0.0) + load.seconds
                       + write.seconds)
    return res


def _finish(cfg: PfbwtConfig, n: int, nruns: int, ssa, esa):
    """The run-length samples (.ssa/.esa with -r, counted in
    ``out_bytes``) and the n/r lines."""
    if cfg.rssa:
        for ext, pairs in ((EXT.SSA, ssa), (EXT.ESA, esa)):
            pairs = pairs.astype(cfg.dtype)
            with open(cfg.prefix + "." + ext, "wb") as f:
                f.write(pairs.tobytes())
            count("out_bytes", pairs.nbytes)
    print(f"n: {n}", file=sys.stderr)
    print(f"r: {nruns}", file=sys.stderr)
    print(f"n/r: {n / nruns:.3f}", file=sys.stderr)


def _run_pfbwt_stream(cfg: PfbwtConfig, dict_flat, occs, bwlast, ilist,
                      bwsai, n, info):
    """-m stage 3: the streamed bounded-memory assembly on cfg.device,
    straight into the output files, with the .gsa/.glcp workspace spill
    (ops/bwt_mmap).  ``info`` receives assemble_bwt_stream's keys,
    peak_assemble and assembly_s (span ``staged.assemble``), which here
    includes the writes."""
    from .ops.bwt_mmap import assemble_bwt_stream

    with span("staged.assemble") as stage:
        with task_timer("generating final BWT (mmap mode)"):
            bwt_fp = _out_handle(cfg, EXT.BWT)
            sa_fp = _out_handle(cfg, EXT.SA) if cfg.sa else None
            try:
                nruns, ssa, esa = assemble_bwt_stream(
                    dict_flat, cfg.w, np.asarray(occs).astype(np.int64),
                    bwlast, ilist, bwsai, n,
                    bwt_fp, sa_fp=sa_fp, want_rssa=cfg.rssa,
                    sa_dtype=cfg.dtype, workspace_prefix=cfg.prefix,
                    workspace_dtype=cfg.dtype, device=cfg.device, info=info,
                )
            finally:
                if bwt_fp is not sys.stdout.buffer:
                    bwt_fp.close()
                if sa_fp is not None and sa_fp is not sys.stdout.buffer:
                    sa_fp.close()
        count("out_bytes",
              (n + 1) * (1 + (np.dtype(cfg.dtype).itemsize if cfg.sa else 0)))
        info["peak_assemble"] = peak_allocated(cfg.device)
        _finish(cfg, n, nruns, ssa, esa)
    info["assembly_s"] = stage.seconds
    return nruns
