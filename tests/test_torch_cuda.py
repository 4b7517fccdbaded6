"""Kernels K1-K5, the fused and staged builds (the staged -m included),
the device SA->MA permute, vcf_to_bwt and merge_pfp on a CUDA card
against the plain PyTorch versions and the CPU run, and the host backend
of stages 2 and 3 against the card's.  Marked ``cuda``: each test
skips when no card is present.  On the card:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``."""

import io

import numpy as np
import pytest
import torch

from pfbwtf_tpu_torch.cli.pfbwt_f import main as cli_main
from pfbwtf_tpu_torch.markers.ma_dev import marker_array_from_sa_dev
from pfbwtf_tpu_torch.markers.mps import write_mps_runs
from pfbwtf_tpu_torch.markers.rle_window import RleWindowArray
from pfbwtf_tpu_torch.ops.bwt import bwt_result
from pfbwtf_tpu_torch.ops.bwt_dev import bwt_result_dev
from pfbwtf_tpu_torch.ops.bwt_mmap import assemble_bwt_stream
from pfbwtf_tpu_torch.ops import bwt_dev, carry, gather
from pfbwtf_tpu_torch.ops.cuda import carry_scan as carry_kernels
from pfbwtf_tpu_torch.ops.cuda import gather as gather_kernels
from pfbwtf_tpu_torch.ops.cuda import hash_scan as k1
from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream
from pfbwtf_tpu_torch.ops.hash import hash_scan
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.pipeline import PfbwtConfig, run_parser_chunked, run_pfbwt
from pfbwtf_tpu_torch.testing import plant_cuts

pytestmark = pytest.mark.cuda

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


BIG_P = (1, 2, 64, 1 << 32, 1 << 63, (1 << 63) + 29, (1 << 64) - 1)


@pytest.mark.parametrize("w,p", [(10, 100), (1, 3), (16, 511), (17, 97),
                                 (32, 97), (10, (1 << 15) + 3),
                                 (4, (1 << 20) - 1), (12, (1 << 31) + 11)]
                         + [(w, p) for w in (31, 32) for p in BIG_P])
def test_k1_equals_plain_on_card(card, w, p):
    """Ragged, short and aligned lengths, each also as a view that starts
    off a 16-byte boundary; planted k-mers must cut."""
    rng = np.random.default_rng(w * 1000 + p % 1000)
    for n in (1, 15, 16, 17, max(w - 1, 1), 2047, 2049, 300_007):
        for off in (0, 1, 15):
            buf = rng.integers(0, 4, size=n + off, dtype=np.uint8)
            pos = plant_cuts(buf[off:], w, p)
            codes = torch.from_numpy(buf).to(card)[off:]
            assert codes.data_ptr() % 16 == off
            before = k1.launches
            got = k1.cut_scan(codes, w, p)
            torch.cuda.synchronize()
            assert k1.launches == before + 1
            want = hash_scan(codes, w, p)
            assert torch.equal(got, want), (n, off)
            assert bool(want[pos].all()), (n, off)


def test_k1_rejects_bad_input(card):
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(10, dtype=torch.int32, device=card), 4, 10)
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(10, dtype=torch.uint8, device=card), 33, 10)
    with pytest.raises(ValueError):
        k1.cut_scan(torch.zeros(20, dtype=torch.uint8, device=card)[::2], 4, 10)


def test_fused_card_equals_cpu(card):
    rng = np.random.default_rng(5)
    records = [("s", rng.choice(ACGT, size=40000))]
    kw = dict(want_sa=True, want_rssa=True)
    got, _ = pfbwt_fused_records(records, ParserParams(), device="cuda", **kw)
    want, _ = pfbwt_fused_records(records, ParserParams(), device="cpu", **kw)
    for field in ("bwt", "sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("bad", [False, True])
def test_fused_stream_dev_card_equals_cpu(card, tmp_path, bad):
    """The char stream built on the card from a FASTA's raw bytes, with
    runs of lowercase and of N (and invalid bytes: a lowercase one in the
    second record, another later in it and a third in the last record):
    the same outputs on the card as on the CPU, or the same message,
    naming the first of them."""
    from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
    from pfbwtf_tpu_torch.utils.errors import PfbwtError

    rng = np.random.default_rng(8)
    unit = rng.choice(ACGT, size=30000)
    fa = tmp_path / "mixed.fa"
    with open(fa, "wb") as f:
        for i in range(3):
            seq = unit.copy()
            seq[rng.integers(0, seq.size, 40)] = rng.choice(ACGT, 40)
            for s0 in rng.integers(0, seq.size - 500, 6):
                seq[s0: s0 + 400] |= 32  # lowercase
            for s0 in rng.integers(0, seq.size - 100, 4):
                seq[s0: s0 + 80] = ord("N" if s0 % 2 else "n")
            if bad and i == 1:
                seq[12345] = ord("j")
                seq[20000] = ord("q")
            if bad and i == 2:
                seq[100] = ord("X")
            f.write(b">h%d\n" % i + seq.tobytes() + b"\n")
    records = read_fasta_bytes(str(fa))
    kw = dict(want_sa=True, want_rssa=True)
    outs = []
    for device in ("cuda", "cpu"):
        try:
            outs.append(pfbwt_fused_records(records, ParserParams(),
                                            device=device, **kw)[0])
        except PfbwtError as err:
            outs.append(str(err))
    got, want = outs
    if bad:
        assert got == want == \
            "invalid character 74/J in input (use --non-acgt-to-a)"
        return
    for field in ("bwt", "sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


def test_fused_stream_card_equals_cpu(card):
    """The streamed build with the streamed J2 and many emission chunks:
    the same files on the card as on the CPU, and K1 launched."""
    rng = np.random.default_rng(6)
    C, _, _ = build_stream([("s", rng.choice(ACGT, size=40000))],
                           ParserParams())
    outs = []
    for device in ("cuda", "cpu"):
        bwt_fp, sa_fp, info = io.BytesIO(), io.BytesIO(), {}
        before = k1.launches
        out = pfbwt_fused_stream(C, 10, 100, bwt_fp=bwt_fp, sa_fp=sa_fp,
                                 want_rssa=True, chunk_target=1 << 12,
                                 j2_stream=True, j2_chunk=1 << 14,
                                 device=device, info=info)
        assert info["n_chunks"] >= 8
        if device == "cuda":
            assert k1.launches > before
        outs.append((bwt_fp.getvalue(), sa_fp.getvalue(), out))
    (gb, gs, go), (cb, cs, co) = outs
    assert gb == cb and gs == cs and go[:3] == co[:3]
    assert np.array_equal(go[3], co[3]) and np.array_equal(go[4], co[4])


@pytest.mark.parametrize("name", ["take", "take_along", "take_rows"])
def test_gather_kernels_equal_plain_on_card(card, name):
    """K2-K4 bit for bit against their plain versions in both tiers: tables
    of 1 and 1000 entries, the last of the shared-memory tier and the first
    of the L2 tier, and 2^20; each table also as a view off a 16-byte
    boundary (offsets 1-3); ragged lengths around the 16-lane unroll;
    index views off a 16-byte boundary; and for K3 and K4 indices in
    [-2T, 2T) (wrap, fill and clip).  Each tier must have run."""
    rng = np.random.default_rng(9)
    plain = getattr(gather, name + "_plain")
    kernel = getattr(gather_kernels, name)
    last_smem = gather_kernels.smem_limit(card.index or 0) // 4
    tiers = dict(gather_kernels.tier_launches)
    for t in (1, 1000, last_smem, last_smem + 1, 1 << 20):
        want_tier = "smem" if t <= last_smem else "l2"
        for toff in (0, 1, 2, 3):
            tbuf = torch.from_numpy(rng.integers(
                -(1 << 31), (1 << 31) - 1, size=t + toff,
                dtype=np.int32)).to(card)
            table = tbuf[toff:]
            assert table.data_ptr() % 16 == 4 * toff
            lo, hi = (0, t) if name == "take" else (-2 * t, 2 * t)
            for n in (1, 3, 4, 5, 15, 16, 17, 63, 65, 8191, 100_003):
                for off in (0, 1, 2, 3):
                    buf = torch.from_numpy(rng.integers(
                        lo, hi, size=n + off, dtype=np.int32)).to(card)
                    idx = buf[off:]
                    before = gather_kernels.launches[name]
                    in_tier = gather_kernels.tier_launches[want_tier]
                    got = kernel(table, idx)
                    torch.cuda.synchronize()
                    assert gather_kernels.launches[name] == before + 1
                    assert (gather_kernels.tier_launches[want_tier]
                            == in_tier + 1), (t, want_tier)
                    assert torch.equal(got, plain(table, idx)), (
                        t, toff, n, off)
    for tier in ("smem", "l2"):
        assert gather_kernels.tier_launches[tier] > tiers[tier]


K5_TILE = 4096  # csrc/carry_scan.cu's kTile (pfbwt_carry_tile)


@pytest.mark.parametrize("n", [1, 2, K5_TILE - 1, K5_TILE, K5_TILE + 1,
                               3 * K5_TILE + 7, 10**6 + 3, 1 << 27])
def test_k5_carry_equals_plain_on_card(card, n):
    """Both ops, forward and reverse, values with -1 and the int64
    extremes, each also as a view 8 bytes off a 16-byte boundary."""
    assert carry_kernels.tile_lanes() == K5_TILE
    g = torch.Generator().manual_seed(n)
    buf = torch.randint(-(1 << 40), 1 << 40, (n + 1,), generator=g)
    buf[::7] = -1
    buf[n // 2] = -(1 << 63)
    buf[n // 3] = (1 << 63) - 1
    buf = buf.to(card)
    for off in (0, 1):
        x = buf[off: off + n]
        assert x.data_ptr() % 16 == 8 * off
        for op in ("max", "min"):
            for reverse in (False, True):
                before = carry_kernels.launches["carry"]
                got = carry_kernels.carry(x, op, reverse)
                torch.cuda.synchronize()
                assert carry_kernels.launches["carry"] == before + 1
                assert got.data_ptr() % 16 == x.data_ptr() % 16
                assert torch.equal(got, carry.carry_plain(x, op, reverse)), (
                    off, op, reverse)


@pytest.mark.parametrize("seed,n_groups", [(0, 1), (1, 3), (2, 1000),
                                           (3, 20000)])
def test_k5_posrank_equals_plain_on_card(card, seed, n_groups):
    """Sorted keys in groups of 1 to 1000 with a random permutation, the
    keys also as a view 8 bytes off a 16-byte boundary (the wrapper then
    aligns the permutation to them)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1001, size=n_groups)
    vals = np.cumsum(rng.integers(1, 6, size=n_groups)) - (1 << 35)
    cks = torch.from_numpy(np.repeat(vals, sizes).astype(np.int64))
    order = torch.from_numpy(rng.permutation(cks.shape[0]).astype(np.int64))
    shifted = torch.cat((cks[:1], cks)).to(card)[1:]
    for off, ck in ((0, cks.to(card)), (1, shifted)):
        assert ck.data_ptr() % 16 == 8 * off
        od = order.to(card)
        before = carry_kernels.launches["posrank"]
        rank, counts = carry_kernels.posrank(ck, od)
        torch.cuda.synchronize()
        assert carry_kernels.launches["posrank"] == before + 1
        want_rank, want_counts = carry.posrank_plain(ck, od)
        assert torch.equal(rank, want_rank), off
        assert torch.equal(counts, want_counts) and int(counts) == n_groups


def test_k5_fused_64mib_checksum_equals_plain_sites(card, monkeypatch):
    """The fused build of a 64 MiB pan-genome (8 haplotypes of 8 MiB, SNPs
    at 0.001): K5 at every site, then every site on its plain version
    (the kernel wrapper's entries replaced for this test only); the same
    files and padded-buffer checksum, and K5 launched once a dict doubling
    round, once for the first round, and once each for the word of each
    dict position, the next separator and the last emitter."""
    fa = _pan_fasta_records(42, 8 << 20, 8, nmut=8389)
    kw = dict(want_sa=True, want_rssa=True)
    got, info = pfbwt_fused_records(fa, ParserParams(), device="cuda", **kw)
    counts = info["counts"]
    assert counts["k5_launches"] == info["rounds"]["dict_sa"] + 4, counts
    monkeypatch.setattr(carry_kernels, "carry", carry.carry_plain)
    monkeypatch.setattr(carry_kernels, "posrank", carry.posrank_plain)
    want, winfo = pfbwt_fused_records(fa, ParserParams(), device="cuda",
                                      **kw)
    assert "k5_launches" not in winfo["counts"]
    assert info["checksum"] == winfo["checksum"]
    for field in ("bwt", "sa", "ssa", "esa"):
        assert np.array_equal(getattr(got, field), getattr(want, field))


def test_fused_64mib_device_tail_equals_host_tail(card):
    """The fused build of the 64 MiB pan-genome samples its runs on the
    card: the same run count and .ssa/.esa as the host tail over the
    downloaded BWT and SA, every output in one pinned block, and a result
    kept across two more builds (whose blocks the host cache recycles)
    still reads as it did.  The tail again over the same arrays on the
    card, with U32 and every want, equals the host tail too."""
    fa = _pan_fasta_records(42, 8 << 20, 8, nmut=8389)
    kw = dict(want_sa=True, want_rssa=True)
    kept, info = pfbwt_fused_records(fa, ParserParams(), device="cuda", **kw)
    c = info["counts"]
    assert c["sample_dev"] == 1
    total = kept.bwt.shape[0]
    out_bytes = 9 * total + 32 * kept.nruns
    assert c["pinned_bytes"] == out_bytes
    want = bwt_result(kept.bwt, kept.sa, True, True, np.uint64)
    assert kept.nruns == want.nruns == info["r"]
    assert kept.ssa.tobytes() == want.ssa.tobytes()
    assert kept.esa.tobytes() == want.esa.tobytes()
    for field in ("bwt", "sa", "ssa", "esa"):
        assert torch.from_numpy(getattr(kept, field)).is_pinned(), field
    first = {f: getattr(kept, f).copy() for f in ("bwt", "sa", "ssa", "esa")}
    for _ in range(2):
        res, _ = pfbwt_fused_records(fa, ParserParams(), device="cuda", **kw)
        assert res.bwt.tobytes() == first["bwt"].tobytes()
        del res
    for f, a in first.items():
        assert getattr(kept, f).tobytes() == a.tobytes(), f

    bwt_d = torch.from_numpy(kept.bwt).to(card)
    sa_d = torch.from_numpy(kept.sa.view(np.int64)).to(card)
    for sa_dtype in (np.uint32, np.uint64):
        for want_sa in (False, True):
            for want_rssa in (False, True):
                got = bwt_result_dev(bwt_d, sa_d, total, total - 1, want_sa,
                                     want_rssa, sa_dtype)
                want = bwt_result(kept.bwt, kept.sa, want_sa, want_rssa,
                                  sa_dtype)
                assert got.nruns == want.nruns
                for f in ("bwt", "sa", "ssa", "esa"):
                    g, w = getattr(got, f), getattr(want, f)
                    assert (g is None) == (w is None), f
                    if w is not None:
                        assert g.dtype == w.dtype, f
                        assert g.tobytes() == w.tobytes(), (f, sa_dtype)


ELEVEN = ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai", "bwt",
          "sa", "ssa", "esa")


def test_staged_card_equals_cpu(card, tmp_path):
    """The staged CLI (-s -r) and the chunked parse on the card write the
    same files as on the CPU, and launch K1 (once per chunk)."""
    rng = np.random.default_rng(7)
    unit = rng.choice(ACGT, size=20000)
    fa = tmp_path / "in.fa"
    with open(fa, "wb") as f:
        for i in range(3):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=40)
            hap[pos] = ACGT[rng.integers(0, 4, size=40)]
            f.write(b">h%d\n" % i + hap.tobytes() + b"\n")
    before = k1.launches
    assert cli_main([str(fa), "-o", str(tmp_path / "gpu"), "-s", "-r"]) == 0
    assert k1.launches == before + 1
    assert cli_main([str(fa), "-o", str(tmp_path / "cpu"), "-s", "-r"],
                    device="cpu") == 0
    params = ParserParams(get_sai=True)
    before = k1.launches
    info = {}
    n = run_parser_chunked(str(fa), str(tmp_path / "chk"), params, 1 << 12,
                           device="cuda", info=info)
    assert k1.launches == before + info["n_chunks"] == before + -(-n // 4096)
    run_pfbwt(PfbwtConfig(prefix=str(tmp_path / "chk"), sa=True, rssa=True,
                          device="cuda"), n)
    for ext in ELEVEN:
        want = (tmp_path / f"cpu.{ext}").read_bytes()
        assert (tmp_path / f"gpu.{ext}").read_bytes() == want, ext
        assert (tmp_path / f"chk.{ext}").read_bytes() == want, ext


def test_marker_array_dev_card_equals_cpu(card):
    """The SA->MA permute on the card: the runs of its CPU run, from a
    permutation with values past every run, as an array and as a tensor
    already on the card."""
    rng = np.random.default_rng(8)
    edges = np.sort(rng.choice(np.arange(1, 200_000), size=4000,
                               replace=False)).astype(np.uint64)
    lists = [np.array([k, k + 7], np.uint64) for k in range(1, 6)]
    buf = io.BytesIO()
    write_mps_runs(buf, edges[0::2], edges[1::2],
                   [lists[i] for i in rng.integers(0, 5, size=2000)])
    mai = RleWindowArray(buf.getvalue())
    sa = np.concatenate((rng.permutation(200_001),
                         rng.integers(200_001, 1 << 40, size=1000)))
    want = marker_array_from_sa_dev(sa, mai, device="cpu")
    for arg in (sa.astype(np.uint64), torch.from_numpy(sa).to(card)):
        got = marker_array_from_sa_dev(arg, mai, device="cuda")
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert len(got[2]) == len(want[2]) > 100
        assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))


def test_assemble_bwt_stream_card_equals_cpu(card, tmp_path):
    """The staged -m stage 3 on the card at chunk 64 (many chunks): the
    .bwt/.sa bytes, runs, samples and .gsa/.glcp of the CPU run; then the
    CLI's -m -s -r on the card equals its run on the CPU."""
    from pfbwtf_tpu_torch.engine import parse_bwt, parse_records

    rng = np.random.default_rng(10)
    records = [("s", rng.choice(ACGT, size=30000))]
    res = parse_records(records, ParserParams(w=4, p=9, get_sai=True),
                        device="cuda")
    pb = parse_bwt(res, device="cuda")
    args = (res.dict_flat(), 4, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n)
    outs = []
    for device in ("cuda", "cpu"):
        bwt_fp, sa_fp, info = io.BytesIO(), io.BytesIO(), {}
        out = assemble_bwt_stream(
            *args, bwt_fp, sa_fp=sa_fp, want_rssa=True, chunk=64,
            workspace_prefix=str(tmp_path / device), device=device,
            info=info)
        assert info["n_chunks"] > 100
        outs.append((bwt_fp.getvalue(), sa_fp.getvalue(), out))
    (gb, gs, go), (cb, cs, co) = outs
    assert gb == cb and gs == cs and go[0] == co[0]
    assert np.array_equal(go[1], co[1]) and np.array_equal(go[2], co[2])
    for ext in ("gsa", "glcp"):
        assert ((tmp_path / f"cuda.{ext}").read_bytes()
                == (tmp_path / f"cpu.{ext}").read_bytes())
    fa = tmp_path / "in.fa"
    fa.write_bytes(b">s\n" + records[0][1].tobytes() + b"\n")
    for device in ("cuda", "cpu"):
        assert cli_main([str(fa), "-o", str(tmp_path / f"m{device}"), "-m",
                         "-s", "-r"], device=device) == 0
    for ext in ELEVEN + ("gsa", "glcp"):
        assert ((tmp_path / f"mcuda.{ext}").read_bytes()
                == (tmp_path / f"mcpu.{ext}").read_bytes()), ext


def test_vcf_to_bwt_card_equals_cpu(card, tmp_path):
    """vcf_to_bwt staged and fused on the card: every file of the CPU run,
    and K1 launched by each build."""
    import shutil

    from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

    from .vcf_gen import random_vcf

    rng = np.random.default_rng(11)
    contigs = [(f"c{i}", rng.choice(ACGT, size=5000).tobytes())
               for i in range(2)]
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s)
                            for n, s in contigs))
    vcf = str(tmp_path / "p.vcf")
    random_vcf(vcf, contigs, rng, nsamples=3, density=0.01, indel_frac=0.2)
    exts = ("bwt", "sa", "ssa", "esa", "ma", "mps", "dict", "occ", "parse",
            "n", "docs", "bwlast", "ilist", "bwsai")
    for fused in (False, True):
        for device in ("cuda", "cpu"):
            name = f"{device}{int(fused)}"
            shutil.copy(fa, tmp_path / f"{name}.fa")
            before = k1.launches
            vcf_to_bwt(VcfToBwtConfig(
                fasta=str(tmp_path / f"{name}.fa"), vcfs=[vcf],
                output=str(tmp_path / name), sa=True, rssa=True, ma=True,
                fused=fused, device=device))
            if device == "cuda":
                assert k1.launches > before
        for ext in exts:
            want = tmp_path / f"cpu{int(fused)}.{ext}"
            got = tmp_path / f"cuda{int(fused)}.{ext}"
            assert want.exists() == got.exists(), ext
            if want.exists():
                assert got.read_bytes() == want.read_bytes(), ext


def _pan_fasta(path, seed, unit_len, copies, nmut=200):
    """Mutated copies of one random unit, one record each."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    with open(path, "wb") as f:
        for i in range(copies):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=nmut)
            hap[pos] = ACGT[rng.integers(0, 4, size=nmut)]
            f.write(b">h%d\n" % i + hap.tobytes() + b"\n")
    return str(path)


def test_merge_pfp_card_equals_cpu(card, tmp_path):
    """merge_pfp -s --parse-bwt on the card at 1 MB (three shards parsed
    on the card, a fourth given as a FASTA): one K1 launch for the merge,
    and the files of its CPU run and of the whole staged build."""
    from pfbwtf_tpu_torch.cli.merge_pfp import main as merge_main

    shards = [_pan_fasta(tmp_path / f"s{i}.fa", 20 + i, 1 << 17, 2)
              for i in range(4)]
    whole = tmp_path / "whole.fa"
    whole.write_bytes(b"".join(open(s, "rb").read() for s in shards))
    assert cli_main([str(whole), "-o", str(tmp_path / "w"), "-s",
                     "--parse-only"]) == 0
    args = []
    for i, s in enumerate(shards[:3]):
        assert cli_main([s, "-o", str(tmp_path / f"p{i}"), "-s",
                         "--parse-only"]) == 0
        args.append(str(tmp_path / f"p{i}"))
    args.append(shards[3])
    before = k1.launches
    assert merge_main([*args, "-o", str(tmp_path / "gpu"), "-s",
                       "--parse-bwt"]) == 0
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert merge_main([*args, "-o", str(tmp_path / "cpu"), "-s",
                       "--parse-bwt"], device="cpu") == 0
    for ext in ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai"):
        want = (tmp_path / f"w.{ext}").read_bytes()
        assert (tmp_path / f"gpu.{ext}").read_bytes() == want, ext
        assert (tmp_path / f"cpu.{ext}").read_bytes() == want, ext


def test_host_backend_equals_device_backend_on_card(card, tmp_path,
                                                    monkeypatch):
    """The staged CLI with stages 2 and 3 on the host (PFBWT_BACKEND=numpy,
    then PFBWT_ASSEMBLE_BACKEND=numpy alone) writes the card's files; K1
    still runs the cut scan."""
    fa = _pan_fasta(tmp_path / "in.fa", 30, 1 << 17, 8)
    for name in ("PFBWT_BACKEND", "PFBWT_ASSEMBLE_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    assert cli_main([fa, "-o", str(tmp_path / "dev"), "-s", "-r"]) == 0
    for name in ("PFBWT_BACKEND", "PFBWT_ASSEMBLE_BACKEND"):
        monkeypatch.setenv(name, "numpy")
        before = k1.launches
        assert cli_main([fa, "-o", str(tmp_path / name), "-s", "-r"]) == 0
        assert k1.launches == before + 1
        monkeypatch.delenv(name)
        for ext in ELEVEN:
            assert ((tmp_path / f"{name}.{ext}").read_bytes()
                    == (tmp_path / f"dev.{ext}").read_bytes()), (name, ext)


def test_stage3_wide_emission_card_equals_default(card, tmp_path,
                                                 monkeypatch):
    """The staged build's stage 3 on the card, resumed from its checkpoint
    files with the emission forced onto the path it takes past 63 key
    bits (assemble_core(wide=True): the scatter fan-out, whose running
    max is K5, and the stable two-key (gid, j) sort): the default
    emission's .bwt/.sa/.ssa/.esa."""
    fa = _pan_fasta(tmp_path / "in.fa", 40, 1 << 17, 8)
    for name in ("PFBWT_BACKEND", "PFBWT_ASSEMBLE_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    pre = tmp_path / "dev"
    assert cli_main([fa, "-o", str(pre), "-s", "-r"]) == 0
    want = {ext: (tmp_path / f"dev.{ext}").read_bytes()
            for ext in ("bwt", "sa", "ssa", "esa")}
    core = bwt_dev.assemble_core
    calls = []

    def wide(*args, **kw):
        calls.append(1)
        return core(*args, wide=True, **kw)

    monkeypatch.setattr(bwt_dev, "assemble_core", wide)
    before = carry_kernels.launches["carry"]
    run_pfbwt(PfbwtConfig(prefix=str(pre), sa=True, rssa=True,
                          device="cuda"), None)
    torch.cuda.synchronize()
    assert calls == [1]
    assert carry_kernels.launches["carry"] > before
    for ext, data in want.items():
        assert (tmp_path / f"dev.{ext}").read_bytes() == data, ext


def _pan_fasta_records(seed, unit_len, copies, nmut=200):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    out = []
    for i in range(copies):
        hap = unit.copy()
        pos = rng.integers(0, hap.size, size=nmut)
        hap[pos] = ACGT[rng.integers(0, 4, size=nmut)]
        out.append((f"h{i}", hap))
    return out


def test_pod_parse_card_equals_staged(card, tmp_path):
    """pfbwt_f -s -r --shards 2 at 1 MB: two spawn workers on the host,
    the merge on the card (one K1 launch in this process), and the
    files of the whole staged build."""
    fa = _pan_fasta(tmp_path / "in.fa", 41, 1 << 17, 8)
    assert cli_main([fa, "-o", str(tmp_path / "whole"), "-s", "-r"]) == 0
    before = k1.launches
    assert cli_main([fa, "-o", str(tmp_path / "pod"), "-s", "-r",
                     "--shards", "2"]) == 0
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    for ext in ELEVEN:
        assert ((tmp_path / f"pod.{ext}").read_bytes()
                == (tmp_path / f"whole.{ext}").read_bytes()), ext


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_mesh_one_rank_nccl_equals_single_device(card, tmp_path, mode):
    """pfbwt_f --mesh and --fused --mesh at 1 MB as a one-rank NCCL world
    in this process (made and destroyed by the call): the files of the
    single-device build, K1 launched; no world is left behind."""
    import torch.distributed as dist

    fa = _pan_fasta(tmp_path / "in.fa", 43, 1 << 17, 8)
    fused = ["--fused"] if mode == "fused" else []
    assert cli_main([fa, "-o", str(tmp_path / "one"), "-s", "-r",
                     *fused]) == 0
    before = k1.launches
    assert cli_main([fa, "-o", str(tmp_path / "mesh"), "-s", "-r", "--mesh",
                     *fused]) == 0
    torch.cuda.synchronize()
    assert k1.launches > before
    assert not dist.is_initialized()
    for ext in (("bwt", "sa", "ssa", "esa") if fused else ELEVEN):
        assert ((tmp_path / f"mesh.{ext}").read_bytes()
                == (tmp_path / f"one.{ext}").read_bytes()), ext


def test_multihost_union_parse_one_rank_nccl_scans_on_card(card, tmp_path):
    """multihost_union_parse as a one-rank NCCL world (made and destroyed
    by the call): the stream's cut scan is one K1 launch on the card, and
    the checkpoint files are those of the single-device parse."""
    import torch.distributed as dist

    from pfbwtf_tpu_torch.parallel.multihost import multihost_union_parse

    fa = _pan_fasta(tmp_path / "in.fa", 44, 1 << 17, 8)
    assert cli_main([fa, "-o", str(tmp_path / "one"), "-s",
                     "--parse-only"]) == 0
    before = k1.launches
    multihost_union_parse(fa, str(tmp_path / "mu"),
                          ParserParams(w=10, p=100, get_sai=True))
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert not dist.is_initialized()
    for ext in ("dict", "occ", "parse", "n", "bwlast", "ilist", "bwsai"):
        assert ((tmp_path / f"mu.{ext}").read_bytes()
                == (tmp_path / f"one.{ext}").read_bytes()), ext
