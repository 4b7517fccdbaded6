"""vcf_to_bwt: reference FASTA + phased VCF panel -> BWT, SA and marker
array (pfbwtf_tpu/vcf/pipeline.py), every heavy stage on one device.

Orchestration equivalent of vcf_to_bwt.py (reference :184-293), minus the
process graph: where the reference wires `vcf_scan | pfbwt-f64 --parse-only`
per haplotype through a multiprocessing.Pool and merges with merge_pfp, we
scan every haplotype on the host (each independent), build ONE parse over
the concatenated collection — exactly equivalent to the reference's
operator+= fold, because the merged parse is a pure function of the
concatenated padded text — and emit the final BWT in one assembly pass.
The SA->MA permute consumes the SA array directly instead of a unix pipe
(vcf_to_bwt.py:258-285).

The parse (kernel K1's cut scan), the parse-BWT, the assembly and the
SA->MA permute run on ``cfg.device``: the staged stages of engine.py, or
with ``cfg.fused`` the fused build of ops/fused.py, or with ``cfg.mesh``
the fused build over the mesh (parallel/fused_mesh.py).  A
``cfg.backend`` of ``"numpy"`` (or the PFBWT_* variables, engine.py)
moves the staged parse-BWT and assembly to the host,
PFBWT_MA_BACKEND=numpy the SA->MA permute (markers/ma.permute_sa).

Haplotype order matches the reference: [ref] + [sample h0, sample h1, ...]
(vcf_to_bwt.py:191-192).
"""

import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import engine
from ..io import formats
from ..io.fasta import write_fai
from ..markers.ma import permute_sa
from ..markers.mps import read_mps_runs, write_mps_runs
from ..markers.rle_window import RleWindowArray
from ..ops.parse import ParserParams
from ..pipeline import save_parser
from ..utils.errors import die
from ..utils.timer import build, span, task_timer
from .reader import merge_vcfs
from .scan import write_scan_outputs
from .scan_worker import scan_task


@dataclass
class VcfToBwtConfig:
    fasta: str
    vcfs: List[str]
    output: str = "out"
    samples: Optional[List[str]] = None  # default: all samples in first VCF
    wsize: int = 10
    mod: int = 100
    ma_wsize: int = 1
    sa: bool = False
    rssa: bool = False
    ma: bool = False
    save_fasta: bool = False
    keep_parse: bool = True
    threads: int = 1
    dtype: np.dtype = formats.U64
    device: str = "cuda"
    backend: Optional[str] = None  # 'numpy': stages 2-3 on the host
    contigs: Optional[List[str]] = None  # restrict (index-seek if .csi/.tbi)
    # the fused build (ops/fused.py) in place of the staged stages; it
    # writes no .parse/.dict checkpoint files (no host-visible parse)
    fused: bool = False
    # the fused build over the mesh (parallel/fused_mesh.py); under
    # torchrun rank 0 scans the panel and writes every file
    mesh: bool = False


def _setup_logger(output: str):
    """Timestamped dual-handler logger (OUT.log file + stderr), the
    reference orchestrator's observability surface (vcf_to_bwt.py:194-202).
    Reconfigured per run so repeated calls don't stack handlers."""
    import logging

    logger = logging.getLogger("pfbwtf_tpu_torch.vcf_to_bwt")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s] %(message)s")
    fh = logging.FileHandler(output + ".log", mode="w")
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def _scan_subprocess(vcf, scan_args: dict, tasks, nworkers: int,
                     names=None):
    """Run the haplotype scans in ``python -m pfbwtf_tpu_torch.vcf.
    scan_worker`` child processes (bounded to ``nworkers`` concurrent),
    returning results in task order.  See scan_worker's docstring for why
    this is neither a fork pool nor multiprocessing spawn."""
    import pickle
    import subprocess
    import tempfile

    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = os.environ.copy()
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="pfbwt_scan") as td:
        ctx_path = os.path.join(td, "ctx.pkl")
        with open(ctx_path, "wb") as f:
            pickle.dump((vcf, scan_args, tasks), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        outs = [os.path.join(td, f"scan{i}.pkl") for i in range(len(tasks))]
        pending = list(range(len(tasks)))
        running: list = []
        logs: list = []
        while pending or running:
            while pending and len(running) < nworkers:
                i = pending.pop(0)
                cmd = [sys.executable, "-m",
                       "pfbwtf_tpu_torch.vcf.scan_worker", ctx_path, str(i),
                       outs[i]]
                # per-stage .log file: command echo + worker stderr
                # (the reference's per-haplotype logs, vcf_to_bwt.py:91,112)
                log_fp = None
                if names is not None:
                    log_fp = open(names[i] + ".log", "w")
                    log_fp.write(" ".join(cmd) + "\n")
                    log_fp.flush()
                    logs.append(log_fp)
                running.append((i, subprocess.Popen(
                    cmd, env=env, stderr=log_fp)))
            i, proc = running.pop(0)
            rc = proc.wait()  # returncode checked per reference
            if rc != 0:       # (vcf_to_bwt.py:130-136)
                for _, p in running:
                    p.terminate()
                    p.wait()
                die(f"haplotype scan worker {i} failed (exit {rc})")
        for fp in logs:
            fp.close()
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def vcf_to_bwt(cfg: VcfToBwtConfig, info: dict = None):
    """The whole pipeline; returns the BWTResult.  ``info`` receives the
    seconds of the stage spans (utils/timer): fai_s (``vcf.fai``), read_s
    (``vcf.read``: the VCF read), scan_s (``vcf.scan``), mps_s
    (``vcf.mps``: the merged .mps, with cfg.ma), build_s (``vcf.build``:
    parse, parse-BWT and assembly or the fused build), write_s
    (``vcf.write``: .bwt/.sa/.ssa/.esa) and ma_s (``vcf.ma``: the SA->MA
    stage, of it ma_index_s reading the merged .mps, ma_permute_s the
    permute with its upload and download, ma_write_s the .ma write); n, r
    and ma_runs; the fused build's keys (ops/fused) with cfg.fused, the
    fused mesh build's and mesh_stats (the mesh's exchanges) with
    cfg.mesh; and spans, counts and build_id.

    With cfg.mesh every rank of the world (one rank without torchrun)
    calls this: rank 0 scans the panel and writes every file, the other
    ranks receive the haplotype records by a broadcast (and any failure
    of the scan as a PfbwtError) and join the build; they return None."""
    info = {} if info is None else info
    with build(info):
        if not cfg.mesh:
            return _vcf_to_bwt(cfg, info, None)
        from ..parallel.sharded import make_parse_mesh

        with make_parse_mesh(cfg.device) as mesh:
            info["mesh_stats"] = mesh.stats
            return _vcf_to_bwt(cfg, info, mesh)


def _vcf_to_bwt(cfg: VcfToBwtConfig, info: dict, mesh):
    root = mesh is None or mesh.rank == 0
    log = _setup_logger(cfg.output) if root else None
    if mesh is None:
        all_records = _scan_panel(cfg, log, info)
    else:
        all_records = mesh.from_root(lambda: _scan_panel(cfg, log, info))
    params = ParserParams(
        w=cfg.wsize,
        p=cfg.mod,
        get_sai=True,
        store_docs=True,
        non_acgt_to_a=True,
    )
    want_sa_vals = cfg.sa or cfg.ma
    with span("vcf.build") as stage:
        if cfg.fused or cfg.mesh:
            if root and cfg.keep_parse:
                log.info("fused pipeline: no host-visible parse exists, "
                         ".parse/.dict checkpoint files are skipped")
            bwt_res = _fused_stages(cfg, log, all_records, params,
                                    want_sa_vals, mesh, info)
        else:
            bwt_res = _staged_stages(cfg, log, all_records, params,
                                     want_sa_vals)
    info["build_s"] = stage.seconds
    if not root:
        return None
    _write_bwt_outputs(cfg, log, bwt_res, info)
    return bwt_res


def _scan_panel(cfg: VcfToBwtConfig, log, info: dict):
    """The .fai, the haplotype scans (in worker processes with --threads),
    the scanned FASTAs with save_fasta and the merged .mps with ma;
    returns every haplotype's records, in the reference's order."""
    with span("vcf.fai") as stage:
        write_fai(cfg.fasta)
    info["fai_s"] = stage.seconds
    with span("vcf.read") as stage:
        vcf = merge_vcfs(cfg.vcfs, contigs=cfg.contigs)
    info["read_s"] = stage.seconds
    samples = cfg.samples if cfg.samples else list(vcf.samples)
    log.info(
        "vcf_to_bwt: %d vcf(s), %d sample(s), w=%d p=%d threads=%d",
        len(cfg.vcfs), len(samples), cfg.wsize, cfg.mod, cfg.threads,
    )

    # scan ref + every haplotype, in worker processes with --threads, the
    # reference's mp.Pool (vcf_to_bwt.py:230-237)
    tasks = [("", 0, True)] + [
        (sample, hap, False) for sample in samples for hap in (0, 1)
    ]
    names = [cfg.output + ".ref"] + [
        f"{cfg.output}.{sample}.{hap}"
        for sample in samples
        for hap in (0, 1)
    ]
    scan_args = {"fasta": cfg.fasta, "w": cfg.wsize,
                 "ma_wsize": cfg.ma_wsize, "want_markers": cfg.ma}
    log.info("generating haplotype sequences from VCF (%d scans)", len(tasks))
    with task_timer("scanning VCF haplotypes", "vcf.scan") as stage:
        if cfg.threads > 1 and len(tasks) > 1:
            scans = _scan_subprocess(
                vcf, scan_args, tasks, min(cfg.threads, len(tasks)),
                names=names,
            )
        else:
            scans = [scan_task(vcf, scan_args, t) for t in tasks]
    info["scan_s"] = stage.seconds
    prefixes = list(zip(names, scans))

    if cfg.save_fasta:
        for name, scan in prefixes:
            write_scan_outputs(scan, name, cfg.wsize)

    # merged .mps: offset each prefix's runs by its cumulative text length
    # (merge_mps semantics, src/merge_mps.cpp:63-81)
    if cfg.ma:
        with task_timer("merging marker positions", "vcf.mps") as stage, \
                open(cfg.output + ".mps", "wb") as ofp:
            bias = 0
            for name, scan in prefixes:
                starts, ends, markers = read_mps_runs(scan.mps_bytes)
                write_mps_runs(
                    ofp,
                    (starts.astype(np.int64) + bias).astype(np.uint64),
                    (ends.astype(np.int64) + bias).astype(np.uint64),
                    markers,
                )
                bias += scan.n(cfg.wsize)
        info["mps_s"] = stage.seconds

    # one parse over the whole collection == merge_pfp fold of per-haplotype
    # parses (vcf_to_bwt.py:242-248)
    return [rec for _, scan in prefixes for rec in scan.records]


def _fused_stages(cfg, log, all_records, params, want_sa_vals, mesh, info):
    """parse -> parse-BWT -> assembly as one device chain: the fused build,
    or over the mesh when there is one (None on ranks other than 0); the
    build's keys go into ``info``."""
    root = mesh is None or mesh.rank == 0
    what = "fused mesh pipeline" if mesh is not None else \
        "fused device pipeline"
    if root:
        log.info("%s over haplotype collection (%d records)", what,
                 len(all_records))
    with task_timer(f"{what} (parse+pfbwt)"):
        if mesh is not None:
            from ..parallel.fused_mesh import pfbwt_fused_mesh_records

            return pfbwt_fused_mesh_records(
                all_records, params, mesh, want_sa=want_sa_vals,
                want_rssa=cfg.rssa, sa_dtype=cfg.dtype, info=info)
        from ..ops.fused import pfbwt_fused_records

        res, fused_info = pfbwt_fused_records(
            all_records, params, device=cfg.device, want_sa=want_sa_vals,
            want_rssa=cfg.rssa, sa_dtype=cfg.dtype)
        info.update(fused_info)
        return res


def _staged_stages(cfg, log, all_records, params, want_sa_vals):
    """parse -> parse-BWT -> assembly through engine.py's stages on
    cfg.device, with the checkpoint files when cfg.keep_parse."""
    log.info("parsing haplotype collection (%d records)", len(all_records))
    with task_timer("parsing collection"):
        res = engine.parse_records(all_records, params, cfg.device)
    if cfg.keep_parse:
        save_parser(res, cfg.output, cfg.dtype)

    with task_timer("bwt of parse"):
        pb = engine.parse_bwt(res, get_sai=True, device=cfg.device,
                              backend=cfg.backend)
    if cfg.keep_parse:
        formats.write_u8(cfg.output + ".bwlast", pb.bwlast)
        formats.write_uint(cfg.output + ".ilist", pb.ilist, cfg.dtype)
        formats.write_uint(cfg.output + ".bwsai", pb.bwsai, cfg.dtype)

    log.info("constructing BWT%s of text collection",
             " + SA" if want_sa_vals else "")
    with task_timer("generating final BWT"):
        return engine.assemble_bwt(
            res.dict_flat(),
            cfg.wsize,
            res.occs.astype(np.int64),
            pb.bwlast,
            pb.ilist,
            pb.bwsai,
            res.n,
            want_sa=want_sa_vals,
            want_rssa=cfg.rssa,
            sa_dtype=cfg.dtype,
            device=cfg.device,
            backend=cfg.backend,
        )


def _write_bwt_outputs(cfg, log, bwt_res, info: dict):
    """Final outputs shared by the staged and fused paths: .bwt/.sa/.ssa/
    .esa files, the SA->MA permute on cfg.device, and the reference's n/r
    stats lines."""
    n = bwt_res.bwt.shape[0] - 1
    with span("vcf.write") as stage:
        with open(cfg.output + ".bwt", "wb") as f:
            f.write(bwt_res.bwt.tobytes())
        if cfg.sa:
            with open(cfg.output + ".sa", "wb") as f:
                f.write(bwt_res.sa.astype(cfg.dtype).tobytes())
        if cfg.rssa:
            with open(cfg.output + ".ssa", "wb") as f:
                f.write(bwt_res.ssa.astype(cfg.dtype).tobytes())
            with open(cfg.output + ".esa", "wb") as f:
                f.write(bwt_res.esa.astype(cfg.dtype).tobytes())
    info["write_s"] = stage.seconds
    if cfg.ma:
        log.info("constructing marker array from SA stream")
        with task_timer("constructing marker array", "vcf.ma") as stage:
            with span("ma.index") as index:
                mai = RleWindowArray(cfg.output + ".mps")
            with span("ma.permute") as permute:
                starts, ends, markers = permute_sa(bwt_res.sa, mai,
                                                   device=cfg.device)
            with span("ma.write") as write:
                with open(cfg.output + ".ma", "wb") as f:
                    write_mps_runs(f, starts, ends, markers)
        info.update(ma_s=stage.seconds, ma_index_s=index.seconds,
                    ma_permute_s=permute.seconds, ma_write_s=write.seconds,
                    ma_runs=len(markers))
    info.update(n=n, r=bwt_res.nruns)
    log.info("done: n=%d r=%d n/r=%.3f", n, bwt_res.nruns,
             n / max(bwt_res.nruns, 1))
    print(f"n: {n}\nr: {bwt_res.nruns}", file=sys.stderr)
