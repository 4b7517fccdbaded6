"""The fused build over the mesh (pfbwtf_tpu/parallel/fused_mesh.py):
the single-device chain of ops/fused.py with its n-scale stages sharded.

  FM-J2   the mesh parse: parallel/dict_union.distributed_parse_records
          (K1 on each rank's block, the collective dictionary rank).
  FM-J3a  ONE dict/phrase-scale step, run replicated on every rank (it
          is dict-sized and deterministic, and JAX hands its outputs to
          every device): the parse-BWT (doubling SA, wrap permutes,
          ilist), the dict suffix sort with exact equality captures, and
          the compacted emitter tables, per emitting suffix its first
          emission slot, group id, BWT-char flags and ilist-slot base
          (ops/bwt_dev.emission_state, as the single-device build).
  FM-J3e  each rank owns lanes [rank W, (rank+1) W) of the n+1 emission
          lanes and builds their single-operand keys ((gid, j) with the
          9 flag bits below j; unique per lane) by one searchsorted into
          the replicated tables and an ilist gather.
  FM-sort one distributed stable sample-sort of the keys (dsort), a
          decode of each rank's sorted keys into its .bwt/.sa share
          (bwt_dev._emit_decode), and the gather of the shares to rank 0
          in rank order, counts first.

Where the packed key would pass ``_KEY_BITS`` bits the build warns and
takes the staged mesh stages 2-3 (pfbwt_mesh.py), exact at any width.
"""

import time
import warnings

import numpy as np
import torch

from ..constants import EndOfDict
from ..ops.bwt import bwt_result
from ..ops.bwt_dev import _emit_decode, dict_sort_part, emission_state
from ..ops.fused import _bucket
from ..ops.parse import ParserParams
from ..ops.parse_bwt import parse_bwt_core
from ..ops.suffix import capture_levels, compact_indices
from .dict_union import distributed_parse_records
from .dsort import _I64MAX, _round_up, dsort_blocks
from .sharded import ParseMesh, gather_to_root

_KEY_BITS = 63  # the packed emission key rides in a non-negative int64


def _j3a_core(dict_flat, occs, ranks_p, last_p, sai_p, nphrases: int,
              nsuf_true: int, w: int, nsuf_b: int, total_b: int,
              n_levels: int):
    """FM-J3a on this rank's device: returns (firstE, gidE, flagsE, baseE,
    ls_tab, bwlast, ilist, bwsai).  Pads of the compacted tables get a
    first slot past every lane, so no lane selects them."""
    bwlast, ilist, bwsai, _ = parse_bwt_core(ranks_p, last_p, sai_p,
                                             nphrases)
    ss = dict_sort_part(dict_flat, w, n_levels=n_levels)
    (_, _, _, gid, _, counts, first, flags, ls_tab, seg_u) = emission_state(
        dict_flat, occs, nsuf_true, w, nsuf_b, ss)
    # the emitting suffixes (counts > 0) in lex order: firstE is strictly
    # increasing, so searchsorted-able
    emit = counts > 0
    eix = compact_indices(emit, nsuf_b, fill=0)
    kvalid = torch.arange(nsuf_b, device=emit.device) < emit.sum()
    firstE = torch.where(kvalid, first[eix], total_b + 1)
    gidE = torch.where(kvalid, gid[eix], 0)
    flagsE = torch.where(kvalid, flags[eix], 0)
    baseE = torch.where(kvalid, (seg_u - first)[eix], 0)
    return firstE, gidE, flagsE, baseE, ls_tab, bwlast, ilist, bwsai


def _key_step(mesh: ParseMesh, firstE, gidE, flagsE, baseE, ilist,
              total: int, W: int, KB: int, nsuf_b: int):
    """FM-J3e: this rank's lanes' (key, lane) pairs; lanes >= total get
    the padding key and lane -1."""
    m_b = ilist.shape[0]
    e = mesh.rank * W + torch.arange(W, device=firstE.device)
    # the owning emitter: the last k with firstE[k] <= e (firstE[0] == 0)
    k = torch.clamp(torch.searchsorted(firstE, e, right=True) - 1, 0,
                    nsuf_b - 1)
    E_j = ilist[torch.clamp(baseE[k] + e, 0, m_b - 1)]
    key = (gidE[k] << (KB + 9)) | (E_j << 9) | flagsE[k]
    valid = e < total
    return torch.where(valid, key, _I64MAX), torch.where(valid, e, -1)


def _decode_step(key, ls_tab, bwlast, bwsai, KB: int, nsuf_b: int):
    """This rank's sorted keys -> (bwt chars, SA values)."""
    gid = key >> (KB + 9)
    ls_ord = ls_tab[torch.clamp(gid, 0, nsuf_b - 1)]
    return _emit_decode(key & 511, (key >> 9) & ((1 << KB) - 1), ls_ord,
                        bwlast, bwsai, bwlast.shape[0])


def pfbwt_fused_mesh_records(records, params: ParserParams, mesh: ParseMesh,
                             want_sa: bool = False, want_rssa: bool = False,
                             sa_dtype=np.uint64, info: dict = None):
    """The whole build over the mesh from FASTA records, byte-identical to
    the single-device builds.  Returns the BWTResult on rank 0 and None
    on the other ranks.  ``info`` receives n (on every rank), the mesh
    parse's keys, j3a_s, keys_s, sort_s, decode_s, gather_s and fetch_s
    (the run sampling on rank 0), or the staged stages' keys after the
    63-bit fallback."""
    info = {} if info is None else info
    res = distributed_parse_records(records, params, mesh, info)
    return _fused_mesh_from_parse(res, params.w, mesh, want_sa, want_rssa,
                                  sa_dtype, info)


def _sync(mesh: ParseMesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _fused_mesh_from_parse(res, w: int, mesh: ParseMesh, want_sa: bool,
                           want_rssa: bool, sa_dtype, info: dict):
    n = res.n
    info["n"] = n
    dict_flat = res.dict_flat()
    occs = np.asarray(res.occs, dtype=np.int64)
    ranks = np.asarray(res.parse_ranks, dtype=np.int64)
    D_true, D, nphrases = occs.shape[0], dict_flat.shape[0], ranks.shape[0]
    nsuf = (D - 1 - D_true) - D_true * w
    total = n + 1
    D_b, nph_b = _bucket(D), _bucket(nphrases)
    nsuf_b, total_b = _bucket(nsuf), _bucket(total)
    # the longest word sizes the captures; it needs a separator-terminated
    # dict (an unterminated tail word would undersize n_levels)
    if D == 0 or dict_flat[-1] > 1:
        raise ValueError("fused_mesh: dict_flat must end with a separator "
                         "byte (EndOfWord/EndOfDict)")
    seps = np.flatnonzero(dict_flat <= 1)
    max_len = int(np.diff(np.concatenate(([-1], seps))).max()) - 1
    n_levels = capture_levels(max_len, w)

    def put(a, size, fill=0, dtype=np.int64):
        out = np.full(size, fill, dtype=dtype)
        out[: a.shape[0]] = a
        return torch.from_numpy(out).to(mesh.device)

    t0 = time.perf_counter()
    firstE, gidE, flagsE, baseE, ls_tab, bwlast, ilist, bwsai = _j3a_core(
        put(dict_flat, D_b, EndOfDict, np.uint8), put(occs, nph_b),
        put(ranks, nph_b), put(np.asarray(res.last, np.uint8), nph_b,
                               dtype=np.uint8),
        put(np.asarray(res.sai, np.uint64).view(np.int64), nph_b),
        nphrases, nsuf, w, nsuf_b, total_b, n_levels)
    m_b = ilist.shape[0]
    KB = int(np.ceil(np.log2(m_b + 2)))
    nsuf_bits = int(np.ceil(np.log2(nsuf_b + 2)))
    if nsuf_bits + KB + 9 > _KEY_BITS:
        from .pfbwt_mesh import mesh_assemble_bwt, mesh_parse_bwt

        warnings.warn("fused-mesh emission key exceeds 63 bits; using the "
                      "staged mesh path", stacklevel=3)
        del firstE, gidE, flagsE, baseE, ls_tab, bwlast, ilist, bwsai
        pb = mesh_parse_bwt(res.parse_ranks, res.last, res.sai, mesh,
                            info=info)
        out = mesh_assemble_bwt(dict_flat, w, occs, pb.bwlast, pb.ilist,
                                pb.bwsai, n, mesh, want_sa=want_sa,
                                want_rssa=want_rssa, sa_dtype=sa_dtype,
                                info=info)
        return out if mesh.rank == 0 else None
    _sync(mesh)
    t1 = time.perf_counter()
    W = _round_up(max(-(-total_b // mesh.size), 64), 64)
    key, lane = _key_step(mesh, firstE, gidE, flagsE, baseE, ilist, total,
                          W, KB, nsuf_b)
    del firstE, gidE, flagsE, baseE
    _sync(mesh)
    t2 = time.perf_counter()
    key_s, _ = dsort_blocks(mesh, key, lane)
    del key, lane
    _sync(mesh)
    t3 = time.perf_counter()
    bwtc, sa_vals = _decode_step(key_s, ls_tab, bwlast, bwsai, KB, nsuf_b)
    del key_s
    _sync(mesh)
    t4 = time.perf_counter()
    bwt_all = gather_to_root(mesh, bwtc)
    sa_all = (gather_to_root(mesh, sa_vals) if want_sa or want_rssa
              else None)
    t5 = time.perf_counter()
    info.update(j3a_s=t1 - t0, keys_s=t2 - t1, sort_s=t3 - t2,
                decode_s=t4 - t3, gather_s=t5 - t4)
    if mesh.rank != 0:
        return None
    if bwt_all.shape[0] != total:
        raise RuntimeError(f"fused-mesh emission count {bwt_all.shape[0]} "
                           f"!= n+1 ({total})")
    sa_np = None
    if sa_all is not None:
        sa_all[0] = n
        sa_np = sa_all.cpu().numpy().view(np.uint64)
    out = bwt_result(bwt_all.cpu().numpy(), sa_np, want_sa, want_rssa,
                     sa_dtype)
    info["fetch_s"] = time.perf_counter() - t5
    return out
