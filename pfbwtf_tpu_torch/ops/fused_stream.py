"""Streamed fused build: chars -> .bwt/.sa for inputs past the memory
ceiling of the monolithic build (the streamed path of
pfbwtf_tpu/ops/fused_stream.py, ``pfbwt_f --fused -m``).

The monolithic J3 holds about ten arrays of the text's length on the
card.  Here nothing of that length is built: emissions are generated in
dict-suffix order, along which the suffix-equality group id never
decreases, so the global (group, ilist-pos) emission sort splits into
independent sorts of group-aligned chunks (reference role: the -m
out-of-core mode, file_wrappers.hpp:36-124, and the final loop of
src/pfbwt-f.cpp:209-349).

  J2   the monolithic J2 of ops/fused.py, or below the switch
       J2_STREAM_ABOVE its streamed form (fused._parse_core_stream).
  J3a  dict bytes, dict suffix sort, rank recovery, parse-BWT (all
       fused._j3_prep_core), the per-suffix emission state
       (bwt_dev.emission_state), and the group-aligned chunk table: for
       the targets c * chunk_target, the first group head whose emission
       prefix reaches each.  Dict-, suffix- and phrase-sized arrays only.
  J3e  one emission chunk: its suffixes fanned out to their occurrences,
       sorted by (gid - gid[s0], ilist pos) in one packed int64 key (exact,
       since chunks never split a group), decoded to BWT bytes and SA
       values, with a checksum.

Host reads: J2's sizes, J3a's chunk table, then either each chunk's
bytes (file mode: chunk c is written while chunk c+1 is computed) or,
in checksum-only mode, one running checksum and invariant count at the
end.

``pfbwt_fused_stream`` is a build (utils/timer.build): spans
``host_prep``; ``j2`` (``j2.upload``, ``j2.run``, ``j2.sizes_read``);
``j3a`` (``j3.dict_flat``, ``j3.dict_sort``, ``j3.ranks_bwt``,
``j3a.state``, ``j3a.table_read``); ``j3e`` (``j3e.fetch``,
``j3e.write``, ``j3e.sample`` of each chunk, ``j3e.checksum_read``);
``files`` (the run samples' concatenation and their writes).  Its host
reads count as ``syncs`` and ``d2h_bytes``, each chunk's download as
``d2h_bytes`` alone.  ``pfbwt_fused_stream_records`` adds ``stream``.
"""

from contextlib import ExitStack

import numpy as np
import torch

from ..utils.device import peak_allocated, resolve_device
from ..utils.errors import die
from ..utils.limits import check_text_width
from ..utils.tables import codes_or_die
from ..utils.timer import build, host_read, span, task_timer
from . import fused
from .bwt_dev import _emit_decode, emission_state
from .bwt_mmap import _ChunkWriter
from .carry import carry_max
from .suffix import capture_levels, compact_indices

_I64_MAX = 2**63 - 1
_MASK64 = (1 << 64) - 1

# The J2 switch: the streamed J2 runs where the monolithic J2 alone would
# take more than half of an 80 GB card, which leaves the other half to
# what the caller holds and to the allocator's slack.  The monolithic J2
# peaked at 47.81 B of device memory per input byte, upload included
# (64 MB pan-genome on an NVIDIA H100 80GB HBM3 at 700 W, printed by
# chip_smoke.py, which fails if a run exceeds the figure below): the
# switch sits at about 835 MB of input.
J2_BYTES_PER_INPUT_BYTE = 47.9
J2_MEMORY_SHARE = 0.5
J2_STREAM_ABOVE = int(J2_MEMORY_SHARE * 80e9 / J2_BYTES_PER_INPUT_BYTE)

# what one emission chunk reads of J3a's state
_CHUNK_KEYS = ("first", "gid", "seg_u", "flags", "ls", "bwlast", "ilist",
               "bwsai")


def _dict_state_core(Tp, parse_ranks, occs, dict_start, dict_len, last, sai,
                     nphrases: int, D: int, dict_total: int, nsuf_true: int,
                     chunk_target: int, w: int, dict_b: int, nsuf_b: int,
                     max_chunks: int, n_levels: int = None):
    """J3a -> (state, table).  ``state`` holds the dict-scale arrays by
    name (those of the JAX package's J3a, ``first`` being its
    ``emis_prefix``, plus ``seg_u`` and ``flags``, the per-suffix ilist
    segment start and BWT-char flags its chunk program gathers).
    ``table`` is [s_starts (max_chunks + 1), bases (max_chunks + 1),
    max chunk size, total]: chunk c emits the slots [bases[c],
    bases[c+1]) from the kept suffixes [s_starts[c], s_starts[c+1])."""
    dict_flat, ss, bwlast, ilist, bwsai, seg_start = fused._j3_prep_core(
        Tp, parse_ranks, occs, dict_start, dict_len, last, sai,
        nphrases, D, dict_total, w, dict_b, n_levels=n_levels,
    )
    with span("j3a.state"):
        (
            sa_kept, suf_valid, ls, gid, u, counts, first, flags, _, seg_u,
        ) = emission_state(dict_flat, occs, nsuf_true, w, nsuf_b, ss,
                           seg_start)
        del ss
        dev = gid.device
        total = counts.sum()
        head = torch.ones(nsuf_b, dtype=torch.bool, device=dev)
        head[1:] = gid[1:] != gid[:-1]
        head &= suf_valid
        gs_idx = compact_indices(head, nsuf_b, fill=nsuf_b)
        gs_pref = torch.where(
            gs_idx < nsuf_b, first[torch.clamp(gs_idx, max=nsuf_b - 1)],
            _I64_MAX,
        )
        targets = torch.arange(max_chunks + 1, device=dev) * chunk_target
        past = targets >= total
        pick = torch.searchsorted(gs_pref, torch.minimum(targets, total))
        s_starts = torch.where(
            past, nsuf_true, gs_idx[torch.clamp(pick, max=nsuf_b - 1)]
        )
        bases = torch.where(
            past, total, first[torch.clamp(s_starts, max=nsuf_b - 1)]
        )
        max_m = (bases[1:] - bases[:-1]).max()
        table = torch.cat((s_starts, bases, torch.stack((max_m, total))))
    state = {
        "dict_flat": dict_flat, "sa_kept": sa_kept, "gid": gid, "u": u,
        "ls": ls, "first": first, "seg_start": seg_start, "seg_u": seg_u,
        "flags": flags, "bwlast": bwlast, "ilist": ilist, "bwsai": bwsai,
    }
    return state, table


def _chunk_core(first, gid, seg_u, flags, ls, bwlast, ilist, bwsai,
                s0: int, s1: int, base: int, m_true: int, n_text: int,
                chunk_b: int):
    """J3e: the slots [base, base + m_true) of the final BWT and SA, from
    the kept suffixes [s0, s1), which cover whole equality groups.
    Returns (bwt chars, SA values, checksum, bad), the first two
    chunk_b long and defined on their first m_true lanes (the JAX package
    narrows the decoded group id to int32, which it wraps on the lanes
    past them).  ``bad`` counts suffixes whose chunk-local group id falls
    outside the chunk-local length table, an invariant the driver
    checks."""
    dev = gid.device
    m_ilist = ilist.shape[0]
    l = torch.arange(chunk_b, device=dev)
    # the chunk's own suffixes only (the JAX package takes chunk_b lanes
    # and masks the rest): lanes sent to one spare slot of a scatter
    # serialise on its address
    ns = min(s1 - s0, chunk_b)
    first_w, gid_w, segu_w, flags_w, ls_w = (
        a[s0: s0 + ns] for a in (first, gid, seg_u, flags, ls))
    first_w = first_w - base
    # each emitting suffix marks its first slot and a cummax fills its
    # run; a zero-count suffix shares the slot of the next emitter, the
    # last of the equal-slot run, which the max picks
    mark = torch.zeros(chunk_b + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, torch.clamp(first_w, max=chunk_b), l[:ns] + 1,
                         reduce="amax")
    E = torch.clamp(carry_max(mark[:chunk_b]) - 1, 0, chunk_b - 1)
    e_valid = l < m_true
    # the suffix length is a function of the group: a chunk-local table
    # recovers it after the sort (local gids are < chunk_b, since every
    # group of the chunk emits at least once)
    lgid = gid_w - gid_w[0]
    out_of_table = (lgid < 0) | (lgid >= chunk_b)
    ls_ltab = torch.zeros(chunk_b + 1, dtype=torch.int64, device=dev)
    ls_ltab.scatter_reduce_(0, torch.where(out_of_table, chunk_b, lgid),
                            ls_w, reduce="amax")
    ls_ltab = ls_ltab[:chunk_b]
    lg, fl = lgid[E], flags_w[E]
    E_j = ilist[torch.clamp(segu_w[E] + l - first_w[E], 0, m_ilist - 1)]
    KB = int(np.ceil(np.log2(m_ilist + 2)))
    cb_bits = int(np.ceil(np.log2(chunk_b + 2)))
    if cb_bits + KB + 9 <= 63:
        # one key: (gid, j) is unique per lane, so the 9 flag bits ride
        # below j without changing the order
        key = (lg << (KB + 9)) | (E_j << 9) | fl
        key_ord = torch.sort(torch.where(e_valid, key, _I64_MAX)).values
        fl_ord = key_ord & 511
        j_ord = (key_ord >> 9) & ((1 << KB) - 1)
        ls_ord = ls_ltab[torch.clamp(key_ord >> (KB + 9), 0, chunk_b - 1)]
    else:
        key = torch.where(e_valid, (lg << KB) | E_j, _I64_MAX)
        key_ord, perm = torch.sort(key)
        j_ord = key_ord & ((1 << KB) - 1)
        ls_ord = ls_ltab[torch.clamp(lg, 0, chunk_b - 1)][perm]
        fl_ord = fl[perm]
    bwtc, sa_vals = _emit_decode(fl_ord, j_ord, ls_ord, bwlast, bwsai,
                                 m_ilist)
    # global slot 0 is the terminator's rotation: SA value n
    sa_vals = torch.where(base + l == 0, n_text, sa_vals)
    checksum = (torch.where(e_valid, bwtc.to(torch.int64), 0).sum()
                + torch.where(e_valid, sa_vals, 0).sum())
    bad = out_of_table.sum()
    return bwtc, sa_vals, checksum, bad


def pfbwt_fused_stream(C: np.ndarray, w: int, p: int, bwt_fp=None,
                       sa_fp=None, sa_dtype=np.dtype("<u8"),
                       chunk_target: int = 48 << 20, max_chunks: int = 256,
                       fetch: bool = None, want_rssa: bool = False,
                       device="cuda", j2_stream: bool = None,
                       j2_chunk: int = None, info: dict = None,
                       ssa_fp=None, esa_fp=None):
    """Whole streamed build over the padded char stream C on ``device``.

    With file objects, or ``want_rssa``, .bwt/.sa are written chunk by
    chunk and the result is (nruns, total, checksum), plus (ssa, esa) with
    ``want_rssa``, which are also written to ``ssa_fp``/``esa_fp`` where
    given (as ``sa_dtype``).  Without (checksum-only mode) only the checksum leaves
    the card: (None, total, checksum).  The checksum is the wrapping
    uint64 sum of every BWT byte and SA value.

    ``j2_stream`` forces the streamed J2 (True) or the monolithic one
    (False); None chooses the streamed J2 for inputs longer than
    J2_STREAM_ABOVE, the port's own switch (the JAX package's sits at
    288 MiB, past its TPU program's ceiling).  ``j2_chunk`` is the
    streamed J2's chunk length (None: 64 MiB).
    ``info``, when given, receives the sizes, the stage seconds (j2_s,
    j3a_s, chunks_s; each ends in a host read) and, on a card, the
    device's peak allocation so far as each stage ends (peak_j2,
    peak_j3a, peak_chunks: torch.cuda.max_memory_allocated, so the stage
    whose figure first reaches the run's peak set it); as the outermost
    entry point also spans, counts and build_id (module docstring)."""
    dev = resolve_device(device)
    if fetch is None:
        fetch = bwt_fp is not None or sa_fp is not None or want_rssa
    info = {} if info is None else info
    with build(info):
        with span("host_prep"):
            codes_or_die(C)
            C_len = int(C.shape[0])
            n = C_len
            n_b = fused._bucket(max(C_len, 1), 1 << 16)
            chars_p = np.empty(n_b, dtype=np.uint8)
            chars_p[:C_len] = C
            chars_p[C_len:] = ord("A")
        if j2_stream is None:
            j2_stream = C_len > J2_STREAM_ABOVE
        if j2_chunk is None:
            j2_chunk = 64 << 20

        with task_timer("streamed build: J2 parse", "j2") as j2:
            with span("j2.upload"):
                chars = torch.from_numpy(chars_p).to(dev)
            del chars_p
            nph_b = fused._bucket(fused.speculative_nphrases(C_len, p))
            if j2_stream:
                state, meta, j2_runs = fused.run_parse_stream(
                    chars, C_len, w, p, nph_b, chunk_target=j2_chunk)
            else:
                state, meta, j2_runs = fused.run_parse(chars, C_len, w, p,
                                                       nph_b)
            del chars
        ncuts, D, dict_total, max_len = meta
        nsuf = (dict_total - 1 - D) - D * w
        n_levels = capture_levels(max_len, w)
        info.update(n=n, n_b=n_b, nphrases=ncuts + 1,
                    nph_b=state[1].shape[0], D=D, dict_total=dict_total,
                    nsuf=nsuf, n_levels=n_levels,
                    j2_stream=j2_stream, j2_runs=j2_runs, j2_s=j2.seconds,
                    peak_j2=peak_allocated(dev))

        with task_timer("streamed build: J3a dict sort, parse-BWT, "
                        "chunk table", "j3a") as j3a:
            st, table = _dict_state_core(
                *state[:-1], ncuts + 1, D, dict_total, nsuf, chunk_target, w,
                fused._bucket(dict_total), fused._bucket(nsuf), max_chunks,
                n_levels=n_levels,
            )
            del state
            st = {k: st[k] for k in _CHUNK_KEYS}
            with span("j3a.table_read"):
                table = host_read(table).tolist()
        info.update(j3a_s=j3a.seconds, peak_j3a=peak_allocated(dev))
        s_starts = table[: max_chunks + 1]
        bases = table[max_chunks + 1: 2 * (max_chunks + 1)]
        max_m, total = table[-2], table[-1]
        if total != n + 1:
            die(f"streamed assembly sizing bug: total {total} != n+1 "
                f"{n + 1}")
        if bases[-1] != total:
            die(f"streamed assembly needs more than {max_chunks} chunks at "
                f"chunk_target={chunk_target} (covered {bases[-1]}/{total});"
                " raise chunk_target or max_chunks")
        chunk_b = fused._bucket(max(max_m, 1))
        info["chunk_b"] = chunk_b

        out = _ChunkWriter(bwt_fp, sa_fp, sa_dtype, want_rssa)
        ck_sum = torch.zeros((), dtype=torch.int64, device=dev)
        bad_sum = torch.zeros((), dtype=torch.int64, device=dev)
        n_chunks = 0
        with task_timer("streamed build: J3e emission chunks",
                        "j3e") as j3e:
            for c in range(max_chunks):
                m_c = bases[c + 1] - bases[c]
                if m_c == 0:
                    continue
                bwt_d, sa_d, ck, bad = _chunk_core(
                    **st, s0=s_starts[c], s1=s_starts[c + 1], base=bases[c],
                    m_true=m_c, n_text=n, chunk_b=chunk_b,
                )
                ck_sum += ck
                bad_sum += bad
                n_chunks += 1
                if fetch:
                    out.put(bases[c], bwt_d[:m_c], sa_d[:m_c])
            out.flush()
            with span("j3e.checksum_read"):
                checksum, nbad = host_read(
                    torch.stack((ck_sum, bad_sum))).tolist()
        info.update(chunks_s=j3e.seconds, n_chunks=n_chunks,
                    peak_chunks=peak_allocated(dev))
        if nbad:
            die(f"streamed assembly invariant violation: {nbad} local gids "
                "exceed the chunk-local table (chunk table sizing bug)")
        checksum &= _MASK64
        info["checksum"] = checksum
        if not fetch:
            return None, total, checksum
        if not want_rssa:
            return out.runs.nruns, total, checksum
        with span("files"):
            ssa, esa = out.runs.finish(total)
            for fp, v in ((ssa_fp, ssa), (esa_fp, esa)):
                if fp is not None:
                    fp.write(v.astype(sa_dtype).tobytes())
    return out.runs.nruns, total, checksum, ssa, esa


def pfbwt_fused_stream_records(records, params, *, open_out=None,
                               want_sa=False, want_rssa=False,
                               sa_dtype=np.dtype("<u8"), device="cuda", **kw):
    """Streamed run over FASTA records (build_stream + pfbwt_fused_stream,
    whose keywords ``kw`` takes), as ops/fused.pfbwt_fused_records is for
    the monolithic build.  ``open_out(ext)``, where given, opens output
    ``ext`` for writing as a context manager of a binary file: ``bwt``,
    ``sa`` with ``want_sa``, ``ssa`` and ``esa`` with ``want_rssa``.  They
    are opened once the text's width is checked, so a text too long for
    ``sa_dtype`` dies before any output or the card is touched.  Returns
    (pfbwt_fused_stream's result, info): ``info`` holds its keys and the
    wall time of build_stream (stream_s, span ``stream``)."""
    from .parse import build_stream

    exts = ()
    if open_out is not None:
        exts = ("bwt",) + ("sa",) * want_sa + ("ssa", "esa") * want_rssa
    info = {}
    with build(info):
        with span("stream") as stream:
            C, _, _ = build_stream(records, params)
        check_text_width(int(C.shape[0]), sa_dtype)
        with ExitStack() as files:
            fps = {e: files.enter_context(open_out(e)) for e in exts}
            out = pfbwt_fused_stream(
                C, params.w, params.p, bwt_fp=fps.get("bwt"),
                sa_fp=fps.get("sa"), ssa_fp=fps.get("ssa"),
                esa_fp=fps.get("esa"), sa_dtype=sa_dtype,
                want_rssa=want_rssa, device=device, info=info, **kw)
    info["stream_s"] = stream.seconds
    return out, info
