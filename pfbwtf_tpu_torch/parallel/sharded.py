"""The mesh family's process model and collectives, and the sharded cut
scan (pfbwtf_tpu/parallel/sharded.py) on ``torch.distributed``.

pfbwtf_tpu drives a ``jax.sharding.Mesh`` of local devices from one
process with ``shard_map`` programs.  Here one rank drives one device in
a ``torch.distributed`` world.  Every mesh function is called on every
rank with the same host input, as the JAX function receives the whole
numpy array; rank r takes block r of it, exchanges with collectives, and
returns what JAX returns on the host (each function says on which
ranks).

The collectives, against the JAX ones they replace:

- ``shift_from`` (``ppermute`` ring shift): ``all_to_all_single`` whose
  split sizes are zero except toward the one destination.  In a one-rank
  world that is a copy to self, which ``send``/``recv`` cannot do (gloo:
  "Pair is not connected").
- ``exchange`` (``all_to_all(tiled=True)`` after a count program): one
  small ``all_to_all_single`` of the per-destination counts, then one
  with the exact split sizes; the counts reach the host once, the only
  host sync of an exchange.
- ``gather_ragged`` / ``gather_to_root`` (the host gathers of sharded
  results): the counts first, then ``all_gather`` / ``gather`` of the
  blocks padded to the largest.
- ``all_gather``, ``all_reduce(SUM)`` (``psum``), ``all_reduce(MAX)``
  (``dsort._max_body``'s all_gather + max) and ``barrier``
  (``multihost_utils.sync_global_devices``) map one to one.

No collective that torch deprecates is used (``all_gather_into_tensor``
warns in 2.13, and its replacement does not exist in 2.11).

The cut scan of a shard is kernel K1 on a card (``ops/hash.cut_mask``).
K1 clears ``cut[:w]`` of its input, so a shard's halo is w codes, not
the w - 1 a k-mer needs: with w - 1 the shard's first live position
would sit at index w - 1 of K1's input and lose its cut (as in
ops/chunked.py).  The text's own ``i >= w`` guard is applied on global
positions.
"""

import os
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.errors import PfbwtError
from ..ops.hash import _shr, cut_mask, wang_hash, window_kmers

# a rank that waits longer than this on a collective raises
WORLD_TIMEOUT = timedelta(minutes=10)
# the variables by which a launcher (torchrun) says there is a world
_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


@dataclass
class ParseMesh:
    """One rank's view of the world (the counterpart of a JAX ``Mesh``):
    its process group, rank, world size and device.  ``stats`` counts
    the exchanges, the rows they sent and the doubling rounds of this
    mesh's calls.  A mesh whose world it made itself (``owned``)
    destroys that world on ``close`` or at the end of a ``with`` block."""

    group: object
    rank: int
    size: int
    device: torch.device
    owned: bool = False
    stats: dict = field(default_factory=lambda: {
        "exchanges": 0, "rows_sent": 0, "rounds": [], "stream_fallbacks": 0})

    def close(self):
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
        self.owned = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def barrier(self):
        dist.barrier(group=self.group)

    def from_root(self, fn):
        """``fn()`` on rank 0, its result on every rank.  An exception on
        rank 0 becomes a PfbwtError with its message on every rank, rank
        0 included, so that every rank leaves at the same point."""
        box, err = [None], None
        if self.rank == 0:
            try:
                box = [(fn(), None)]
            except Exception as e:  # told to every rank, then raised
                err = e
                box = [(None, str(e) if isinstance(e, PfbwtError)
                        else f"{type(e).__name__}: {e}")]
        dist.broadcast_object_list(box, src=0, group=self.group)
        value, msg = box[0]
        if msg is not None:
            raise PfbwtError(msg) from err
        return value


def make_parse_mesh(device="cuda") -> ParseMesh:
    """The mesh of this rank (the counterpart of sharded.py:32).

    A world that is already initialized (a caller's
    ``init_process_group``) is used as it is.  Otherwise, under a
    launcher (torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT; any of RANK, WORLD_SIZE or MASTER_ADDR counts), the
    rank joins the launcher's world through ``env://``; with none of
    them it makes a one-rank world on an in-process store (no TCP port).
    The backend is ``nccl`` on a card and ``gloo`` for ``device="cpu"``;
    the rank takes ``cuda:{LOCAL_RANK}`` (the given or current card
    without LOCAL_RANK).  A world made here is owned by the returned
    mesh: use it in a ``with`` block, so that the next call can make its
    own."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", idx)))
        torch.cuda.set_device(dev)
    owned = False
    if not dist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if any(v in os.environ for v in _LAUNCHER_VARS):
            kw["init_method"] = "env://"
        else:
            kw.update(store=dist.HashStore(), rank=0, world_size=1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=WORLD_TIMEOUT, **kw)
        owned = True
    return ParseMesh(group=dist.group.WORLD, rank=dist.get_rank(),
                     size=dist.get_world_size(), device=dev, owned=owned)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def shift_from(mesh: ParseMesh, x: torch.Tensor, d: int) -> torch.Tensor:
    """The ``x`` of rank (rank + d) mod size, on every rank (``x`` has
    one shape on every rank): the ring shift."""
    n = mesh.size
    send, recv = [0] * n, [0] * n
    send[(mesh.rank - d) % n] = x.shape[0]
    recv[(mesh.rank + d) % n] = x.shape[0]
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), recv, send, group=mesh.group)
    return out


def exchange(mesh: ParseMesh, rows: torch.Tensor, dest: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Send each row of ``rows`` ((N, ...) on the rank's device) to rank
    ``dest[i]``; rows where ``valid`` is false are dropped.  Returns the
    rows received, grouped by source rank in rank order, each group in
    its sender's order."""
    n = mesh.size
    dest = torch.where(valid, dest, n)  # a bucket past the last rank
    rows = rows[torch.argsort(dest, stable=True)]
    send = torch.bincount(dest, minlength=n + 1)[:n]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    send_l, recv_l = torch.stack((send, recv)).tolist()  # the host sync
    out = rows.new_empty((sum(recv_l),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows[: sum(send_l)].contiguous(), recv_l,
                           send_l, group=mesh.group)
    mesh.stats["exchanges"] += 1
    mesh.stats["rows_sent"] += sum(send_l)
    return out


def all_gather_rows(mesh: ParseMesh, x: torch.Tensor) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x`` (one shape on every rank)."""
    outs = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(outs, x.contiguous(), group=mesh.group)
    return torch.stack(outs)


def _counts(mesh: ParseMesh, x: torch.Tensor):
    return all_gather_rows(
        mesh, torch.tensor([x.shape[0]], device=x.device)).flatten().tolist()


def _padded(x: torch.Tensor, m: int) -> torch.Tensor:
    pad = x.new_zeros((m,) + tuple(x.shape[1:]))
    pad[: x.shape[0]] = x
    return pad


def gather_ragged(mesh: ParseMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (lengths may differ) concatenated in rank
    order, on every rank."""
    sizes = _counts(mesh, x)
    m = max(sizes)
    if m == 0:
        return x.new_empty((0,) + tuple(x.shape[1:]))
    outs = all_gather_rows(mesh, _padded(x, m))
    return torch.cat([o[:s] for o, s in zip(outs, sizes)])


def gather_to_root(mesh: ParseMesh, x: torch.Tensor):
    """Every rank's ``x`` concatenated in rank order on rank 0; None on
    the other ranks."""
    sizes = _counts(mesh, x)
    m = max(sizes)
    if m == 0:
        return x.new_empty((0,) + tuple(x.shape[1:])) if mesh.rank == 0 \
            else None
    outs = ([torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device) for _ in range(mesh.size)]
            if mesh.rank == 0 else None)
    dist.gather(_padded(x, m), outs, dst=0, group=mesh.group)
    if mesh.rank != 0:
        return None
    return torch.cat([o[:s] for o, s in zip(outs, sizes)])


# --------------------------------------------------------------------------
# the sharded cut scan
# --------------------------------------------------------------------------


def prev_codes(mesh: ParseMesh, blk: torch.Tensor, need: int) -> torch.Tensor:
    """The ``need`` elements before this rank's block in rank order (the
    ring wraps for the first ranks; callers mask those positions), from
    as many ranks back as a short block needs."""
    L = blk.shape[0]
    if L == 0:
        return blk.new_zeros(need)
    hops = -(-need // L)
    parts = [shift_from(mesh, blk, -h) for h in range(hops, 0, -1)]
    return torch.cat(parts)[-need:] if need else blk[:0]


def _blocks_of(codes: np.ndarray, mesh: ParseMesh):
    """This rank's block of ``codes`` padded with 'A' codes (0) to
    size * shard_len, on its device; and shard_len."""
    n = codes.shape[0]
    shard_len = -(-n // mesh.size)
    blk = np.zeros(shard_len, dtype=np.uint8)
    part = codes[mesh.rank * shard_len: (mesh.rank + 1) * shard_len]
    blk[: part.shape[0]] = part
    return torch.from_numpy(blk).to(mesh.device), shard_len


def _shard_parse_block(mesh: ParseMesh, codes_blk: torch.Tensor, w: int,
                       p: int, shard_len: int):
    """Halo exchange + cut scan (K1 on a card) + global phrase count.
    ``codes_blk`` is this rank's (shard_len,) uint8 block of codes.
    Returns (cut (shard_len,) bool, the count over every rank's block,
    padding included, as a 0-d int64 tensor) and the extended codes."""
    ext = torch.cat((prev_codes(mesh, codes_blk, w), codes_blk))
    cut = cut_mask(ext, w, p)[w:]
    gpos = mesh.rank * shard_len + torch.arange(shard_len,
                                                device=codes_blk.device)
    cut &= gpos >= w
    total = cut.sum().reshape(1)
    dist.all_reduce(total, group=mesh.group)
    return cut, total[0], ext


def sharded_parse_step(w: int, p: int, mesh: ParseMesh, shard_len: int):
    """The per-rank step (what pfbwtf_tpu's dryrun_multichip compiles):
    this rank's (shard_len,) block of codes -> (cut mask, global count)."""
    def step(codes_blk):
        cut, total, _ = _shard_parse_block(mesh, codes_blk, w, p, shard_len)
        return cut, total
    return step


def sharded_cut_mask(codes: np.ndarray, w: int, p: int, mesh: ParseMesh):
    """The global cut mask of a code array over the mesh, on every rank.
    The stream is padded to a multiple of the world size with 'A' codes;
    the count covers the padding as JAX's psum does.  Returns (cut_mask
    (n,) bool numpy, total phrase count)."""
    n = codes.shape[0]
    blk, shard_len = _blocks_of(codes, mesh)
    cut, total, _ = _shard_parse_block(mesh, blk, w, p, shard_len)
    allc = all_gather_rows(mesh, cut.to(torch.uint8))
    return allc.flatten()[:n].cpu().numpy().astype(bool), int(total)


def sharded_phrase_sketch(codes: np.ndarray, w: int, p: int,
                          mesh: ParseMesh, sketch_bits: int = 16):
    """The 2**sketch_bits-bucket count of each cut's end-window hash
    (bits 40 and up), summed over the mesh, on every rank: identical
    phrases land in identical buckets whichever shard saw them."""
    blk, shard_len = _blocks_of(codes, mesh)
    cut, _, ext = _shard_parse_block(mesh, blk, w, p, shard_len)
    h = wang_hash(window_kmers(ext, w))[w:]
    nb = 1 << sketch_bits
    local = torch.zeros(nb, dtype=torch.int64, device=blk.device)
    local.index_add_(0, _shr(h, 40) % nb, cut.to(torch.int64))
    dist.all_reduce(local, group=mesh.group)
    return local.cpu().numpy()

