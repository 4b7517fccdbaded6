"""Distributed sort and gather primitives and the distributed prefix
doubling (pfbwtf_tpu/parallel/dsort.py) on ``torch.distributed``.

Every primitive works on this rank's block of rows, on its device, and
the blocks stay there between steps.  Keys are int64 whose signed order
is the order wanted (the non-negative keys here; uint64 chunk rows ride
with the sign bit flipped, parallel/dict_union.py); ``_I64MAX`` stands
for the JAX package's U64MAX padding, and -1 marks an invalid position
or payload.  An exchange sends only the valid rows, with exact split
sizes, so a block that leaves a sort holds exactly the rows it received:
the JAX package's ``pair_cap`` padding does not arise.

  dsort_blocks          global sample-sort of (key, payload...): this
                        rank's share of the global order, ties broken by
                        the first payload (the position), so the result is
                        the stable sort whatever the world size
  dense_ranks           0-based dense group ids over block-major sorted
                        keys
  route_to_slots        exact scatter of (pos, val) to the owner of the
                        position block pos // W
  dist_gather           out[tag] = table[idx] for a position-sharded table
  global_max            the largest value of every rank's block
  distributed_doubling  Manber-Myers over the mesh, the host driving the
                        rounds; the same SA as the single-device doubling
"""

import numpy as np
import torch
import torch.distributed as dist

from ..ops.fused import _lexsort
from .sharded import (ParseMesh, all_gather_rows, exchange, gather_ragged,
                      shift_from)

_I64MAX = 2**63 - 1


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def _sort_bucket(mesh: ParseMesh, key: torch.Tensor, valid: torch.Tensor):
    """Sample-sort bucket of each row: size - 1 global splitters from
    every rank's regular samples of its sorted valid keys (all
    gathered), then ``searchsorted(side="right")``, so equal keys share a
    bucket.  Deterministic in the data.  One rank needs no splitters."""
    n = mesh.size
    if n == 1:
        return torch.zeros_like(key)
    k0 = torch.where(valid, key, _I64MAX)
    cap = k0.shape[0]
    if cap:
        sortk = torch.sort(k0).values
        pos = (torch.arange(1, n + 1, device=key.device) * valid.sum()
               ) // (n + 1)
        samples = sortk[torch.clamp(pos, 0, cap - 1)]
    else:
        samples = torch.full((n,), _I64MAX, dtype=torch.int64,
                             device=key.device)
    all_sorted = torch.sort(all_gather_rows(mesh, samples).flatten()).values
    splitters = all_sorted[torch.arange(1, n, device=key.device) * n]
    return torch.searchsorted(splitters, k0, right=True)


def dsort_blocks(mesh: ParseMesh, key: torch.Tensor, *pays: torch.Tensor):
    """Global sample-sort of this rank's (key, payload...) rows, the rows
    with ``pays[0] >= 0`` only.  Returns (key, payload...) of this rank's
    share of the global order, sorted; the shares lie in rank order.
    Key ties break by the first payload."""
    valid = pays[0] >= 0
    bucket = _sort_bucket(mesh, key, valid)
    got = exchange(mesh, torch.stack((key, *pays), 1), bucket, valid)
    order = _lexsort((got[:, 1], got[:, 0]))
    got = got[order]
    return tuple(got[:, j] for j in range(got.shape[1]))


def dense_ranks(mesh: ParseMesh, key: torch.Tensor) -> torch.Tensor:
    """0-based dense group ids over keys sorted across the ranks in rank
    order.  Padding (``_I64MAX``) rows open no group.  A rank's first key
    is compared with the last valid key of the nearest rank before it
    that has one (JAX's ring stitch, which looks one rank back, assumes
    none is empty); the first key, the last valid key, the valid count
    and the inner group count of every rank come in one all_gather."""
    is_pad = key == _I64MAX
    N = key.shape[0]
    changed = torch.zeros(N, dtype=torch.int64, device=key.device)
    changed[1:] = (key[1:] != key[:-1]) & ~is_pad[1:]
    nvalid = (~is_pad).sum()
    first = key[:1] if N else key.new_full((1,), _I64MAX)
    last = key[torch.clamp(nvalid - 1, 0, max(N - 1, 0))].reshape(1) \
        if N else first
    stat = torch.cat((first, last, nvalid.reshape(1),
                      changed.sum().reshape(1)))
    rows = all_gather_rows(mesh, stat).tolist()  # the host sync
    base, prev_last, mine = 0, None, 0
    for r, (f, la, nv, inner) in enumerate(rows):
        opens = int(nv > 0 and (prev_last is None or f != prev_last))
        if r == mesh.rank:
            mine = opens
            break
        base += inner + opens
        if nv > 0:
            prev_last = la
    if N:
        changed[0] = mine
    return base + torch.cumsum(changed, 0) - 1


def route_to_slots(mesh: ParseMesh, pos: torch.Tensor, val: torch.Tensor,
                   W: int) -> torch.Tensor:
    """This rank's dense (W,) int64 slab of out[pos] = val over every
    rank's (pos, val) rows (pos -1: none); rank r owns positions [rW,
    (r+1)W).  Each slot is written at most once; unwritten slots are 0."""
    dest = torch.clamp(pos // W, 0, mesh.size - 1)
    got = exchange(mesh, torch.stack((pos, val), 1), dest, pos >= 0)
    out = torch.zeros(W, dtype=torch.int64, device=pos.device)
    out.index_add_(0, got[:, 0] % W, got[:, 1])
    return out


def dist_gather(mesh: ParseMesh, table: torch.Tensor, idx: torch.Tensor,
                tag: torch.Tensor, W: int, out_W: int) -> torch.Tensor:
    """out[tag] = table[idx] for a table sharded in blocks of W; idx and
    tag use -1 padding.  Returns this rank's dense (out_W,) slab."""
    dest = torch.clamp(idx // W, 0, mesh.size - 1)
    got = exchange(mesh, torch.stack((idx, tag), 1), dest,
                   (idx >= 0) & (tag >= 0))
    val = table[torch.clamp(got[:, 0] % W, 0, W - 1)]
    return route_to_slots(mesh, got[:, 1], val, out_W)


def global_max(mesh: ParseMesh, blk: torch.Tensor) -> int:
    """The largest element over every rank's block (a host int)."""
    local = (blk.max() if blk.numel()
             else torch.tensor(-_I64MAX - 1, device=blk.device))
    local = local.reshape(1).to(torch.int64)
    dist.all_reduce(local, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(local[0])


# --------------------------------------------------------------------------
# distributed prefix doubling
# --------------------------------------------------------------------------


def _ckey(mesh: ParseMesh, rank_blk: torch.Tensor, W: int, q: int, r: int,
          n: int):
    """One round's packed sort key ckey[i] = rank[i]*(n+1) + rank[i+k]+1
    with k = q*W + r: rank[i+k] is a global left shift, two ring shifts
    (one when r == 0) and static slices.  Positions >= n get the padding
    key and position -1."""
    a = shift_from(mesh, rank_blk, q)
    if r > 0:
        b = shift_from(mesh, rank_blk, q + 1)
        shifted = torch.cat((a[r:], b[:r]))
    else:
        shifted = a
    gpos = mesh.rank * W + torch.arange(W, device=rank_blk.device)
    key2 = torch.where(gpos + (q * W + r) < n, shifted, -1)
    ck = torch.where(gpos < n, rank_blk * (n + 1) + key2 + 1, _I64MAX)
    return ck, torch.where(gpos < n, gpos, -1)


def distributed_doubling(seq: np.ndarray, mesh: ParseMesh) -> np.ndarray:
    """SA of an int64 sequence (non-negative values, unique minimum last)
    over the mesh, on every rank: the order of the single-device doubling,
    by sample-sorts and exact position routing.  The host drives the
    rounds (one global max a round); the rank blocks stay on the devices.
    The final rank is a permutation, so the SA is its inverse, routed
    (``route_to_slots``) rather than sorted.  The round count is appended
    to ``mesh.stats["rounds"]``."""
    seq = np.asarray(seq, dtype=np.int64)
    n = seq.shape[0]
    W = _round_up(max(-(-n // mesh.size), 64), 64)
    dev = mesh.device
    lo = mesh.rank * W
    gpos = lo + torch.arange(W, device=dev)
    pos_blk = torch.where(gpos < n, gpos, -1)
    key0 = np.full(W, _I64MAX, dtype=np.int64)
    part = seq[lo: lo + W]
    key0[: part.shape[0]] = part
    sk, spos = dsort_blocks(mesh, torch.from_numpy(key0).to(dev), pos_blk)
    rank_blk = route_to_slots(mesh, spos, dense_ranks(mesh, sk), W)

    k, nround = 1, 0
    while k < n and global_max(mesh, rank_blk) < n - 1:
        q, r = divmod(k, W)
        ck, posb = _ckey(mesh, rank_blk, W, q, r, n)
        sk, spos = dsort_blocks(mesh, ck, posb)
        rank_blk = route_to_slots(mesh, spos, dense_ranks(mesh, sk), W)
        k *= 2
        nround += 1
    mesh.stats["rounds"].append(nround)
    sa_blk = route_to_slots(mesh, torch.where(gpos < n, rank_blk, -1),
                            gpos, W)
    return gather_ragged(mesh, sa_blk)[:n].cpu().numpy()
