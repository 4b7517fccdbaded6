"""Stages 2-3 with their sorts over the mesh (pfbwtf_tpu/parallel/
pfbwt_mesh.py): the reference's sacak_int / gsacak / final-sweep roles
(gsa/gsacak.c:2499,2504, pfbwt.hpp:97-194).

Distributed: the parse suffix sort (stage 2, distributed doubling), the
parse-BWT ilist counting sort (a stable distributed sample-sort), the
dict generalized suffix sort (stage 3, distributed doubling over the
per-word separator symbols) and the final emission sort by (suffix
group, ilist position), one sample-sort of packed int64 keys.  The
per-element metadata between them (wrap gathers, the emission fan-out)
is O(n) host numpy, as in the JAX package, on every rank; so are the
suffix groups (adjacent kept suffixes equal as strings), the
hash-and-verify groups of ops/suffix_np.suffix_group_ids_np.
"""

import time
from typing import Optional

import numpy as np
import torch

from ..ops.bwt import BWTResult, _emissions, bwt_result
from ..ops.parse_bwt import ParseBWT, bwt_of_parse
from ..ops.suffix_np import dict_initial_symbols_np
from .dsort import _I64MAX, _round_up, distributed_doubling, dsort_blocks
from .sharded import ParseMesh, gather_ragged


def _block(arr: np.ndarray, mesh: ParseMesh, fill: int) -> torch.Tensor:
    """This rank's block of ``arr`` in blocks of W = the mesh's share
    rounded up to 64, padded with ``fill``, as int64 on its device."""
    n = arr.shape[0]
    W = _round_up(max(-(-n // mesh.size), 64), 64)
    out = np.full(W, fill, dtype=np.int64)
    part = arr[mesh.rank * W: (mesh.rank + 1) * W]
    out[: part.shape[0]] = part
    return torch.from_numpy(out).to(mesh.device)


def dist_stable_argsort(keys: np.ndarray, mesh: ParseMesh) -> np.ndarray:
    """Stable argsort of non-negative int64 keys by the distributed
    sample-sort (ties break by position), on every rank."""
    n = keys.shape[0]
    kb = _block(np.asarray(keys, dtype=np.int64), mesh, _I64MAX)
    pb = _block(np.arange(n, dtype=np.int64), mesh, -1)
    _, spos = dsort_blocks(mesh, kb, pb)
    return gather_ragged(mesh, spos).cpu().numpy()


def mesh_parse_bwt(parse_ranks, last, sai, mesh: ParseMesh,
                   get_sai: bool = True, info: dict = None) -> ParseBWT:
    """Stage 2 on every rank, with the parse's suffix sort and the ilist
    sort over the mesh; the wrap gathers are ops/parse_bwt.bwt_of_parse's.
    ``info`` receives parse_sa_s (the doubling and the permutes) and
    ilist_s."""
    info = {} if info is None else info
    t0 = time.perf_counter()
    pb = bwt_of_parse(parse_ranks, last, sai, get_sai=get_sai,
                      sa_fn=lambda seq: distributed_doubling(seq, mesh))
    t1 = time.perf_counter()
    ilist = dist_stable_argsort(pb.bwt_sym.astype(np.int64), mesh)
    info.update(parse_sa_s=t1 - t0, ilist_s=time.perf_counter() - t1)
    return ParseBWT(bwlast=pb.bwlast, ilist=ilist.astype(np.int64),
                    bwsai=pb.bwsai, bwt_sym=pb.bwt_sym)


def mesh_assemble_bwt(dict_flat: np.ndarray, w: int, occs: np.ndarray,
                      bwlast: np.ndarray, ilist: np.ndarray,
                      bwsai: Optional[np.ndarray], n: int, mesh: ParseMesh,
                      want_sa: bool = False, want_rssa: bool = False,
                      sa_dtype=np.uint64, info: dict = None) -> BWTResult:
    """Stage 3 on every rank, with the dict gSA (distributed doubling) and
    the final emission order (distributed sample-sort) over the mesh.
    ``info`` receives dict_sa_s, layout_s (the host suffix groups and
    emission layout), emit_sort_s and decode_s (the host gathers and run
    sampling)."""
    info = {} if info is None else info
    t0 = time.perf_counter()
    dict_flat = np.asarray(dict_flat, dtype=np.uint8)
    sym, word_id, suf_len, _ = dict_initial_symbols_np(dict_flat)
    sa_all = distributed_doubling(sym.astype(np.int64), mesh)
    t1 = time.perf_counter()
    sa_kept, gid, _, suf_len_kept, E_suffix, E_j = _emissions(
        dict_flat, w, occs, ilist, sa_all=sa_all, word_id=word_id,
        suf_len=suf_len)
    total = E_j.shape[0]
    if total != n + 1:
        raise RuntimeError(f"emission count {total} != n+1 ({n + 1})")
    # one packed key per emission: (suffix group, parse-BWT position)
    key = gid[E_suffix].astype(np.int64) * np.int64(total + 1) + E_j.astype(
        np.int64)
    t2 = time.perf_counter()
    order = dist_stable_argsort(key, mesh)
    t3 = time.perf_counter()
    s_ord = E_suffix[order]
    j_ord = E_j[order]
    pos_ord = sa_kept[s_ord]
    is_word_start = np.concatenate(([True], dict_flat[:-1] <= 1))
    bwtc = np.where(
        is_word_start[pos_ord],
        np.asarray(bwlast, dtype=np.uint8)[j_ord],
        np.where(pos_ord == 1, np.uint8(0),
                 dict_flat[np.maximum(pos_ord - 1, 0)]),
    ).astype(np.uint8)
    sa_vals = None
    if want_sa or want_rssa:
        sa_vals = (np.asarray(bwsai).astype(np.uint64)[j_ord]
                   - suf_len_kept[s_ord].astype(np.uint64))
        sa_vals[0] = np.uint64(n)
    res = bwt_result(bwtc, sa_vals, want_sa, want_rssa, sa_dtype)
    info.update(dict_sa_s=t1 - t0, layout_s=t2 - t1, emit_sort_s=t3 - t2,
                decode_s=time.perf_counter() - t3)
    return res
