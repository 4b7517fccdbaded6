"""The generators, the reference and the counts at tiny sizes, against
brute force."""

import os

import numpy as np
import pytest
import torch

from pfbench.counts import k1
from pfbench.generators import panel as gen_panel
from pfbench.generators import pangenome
from pfbench.reference import panel as ref_panel
from pfbench.reference import sa as ref_sa
from pfbench.reference.text import collection_text, read_fasta


def _brute_sa(text: bytes):
    n = len(text)
    # the terminator sorts below every byte: compare with a sentinel -1
    return [n] + sorted(range(n), key=lambda i: list(text[i:]) + [-1])


@pytest.mark.parametrize("text", [b"", b"A", b"ACGTACGTAAAAAAAAAA",
                                  b"GATTACAGATTACAGATTACA" * 3])
def test_suffix_array_bwt_and_samples_match_brute_force(text):
    t = np.frombuffer(text, dtype=np.uint8).copy()
    sa, _ = ref_sa.suffix_array(t, "cpu")
    want = _brute_sa(text)
    assert sa.tolist() == want
    bwt = ref_sa.bwt_of(torch.from_numpy(t), sa)
    assert bwt.tolist() == [text[s - 1] if s > 0 else 0 for s in want]
    ssa, esa = ref_sa.run_samples(bwt, sa)
    b = bwt.tolist()
    starts = [i for i in range(len(b)) if i == 0 or b[i] != b[i - 1]]
    ends = [i for i in range(len(b)) if i == len(b) - 1 or b[i] != b[i + 1]]
    assert ssa.tolist() == [x for i in starts for x in (i, want[i])]
    assert esa.tolist() == [x for i in ends for x in (i, want[i])]


def test_control_sorts_only_a_prefix_of_each_suffix():
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 4, 500).astype(np.uint8) + ord("A")
    text = np.concatenate([unit, unit, unit])
    sa, rounds = ref_sa.suffix_array(text, "cpu")
    short, r = ref_sa.suffix_array(text, "cpu", max_rounds=rounds - 1)
    assert r == rounds - 1 and not torch.equal(sa, short)
    depth = 1 << (rounds - 1)
    keys = [bytes(text[s:s + depth]) for s in short.tolist()[1:]]
    assert keys == sorted(keys)


@pytest.mark.parametrize("traffic, n_records, nmut", [
    ({"haplotypes": 8, "snp_rate": 0.001}, 8, 8),
    ({"haplotypes": 64, "snp_rate": 0.00002}, 64, 0),
])
def test_pangenome_is_seeded_and_sized(tmp_path, traffic, n_records, nmut):
    files = []
    for k, seed in enumerate((2**33 + 5, 2**33 + 5, 11)):
        d = tmp_path / str(k)
        d.mkdir()
        inp = pangenome.make({"text_bp": 1 << 16}, traffic, seed, str(d))
        files.append(open(inp["fasta"], "rb").read())
        recs = read_fasta(inp["fasta"])
        assert len(recs) == n_records and inp["bases"] == 1 << 16
        assert sum(len(s) for _, s in recs) == 1 << 16
        assert int(len(recs[0][1]) * traffic["snp_rate"]) == nmut
    assert files[0] == files[1] and files[0] != files[2]


def test_pangenome_full_size_record_counts():
    # the cell's own numbers: 8 x 32 MiB at 0.001
    unit = (256 << 20) // 8
    assert unit * 8 == 268435456 and int(unit * 0.001) == 33554


def _tiny_panel(tmp_path, seed):
    config = {"contig_bp": [3000, 2000], "samples": 3}
    traffic = {"density": 0.02, "af": 0.4, "indel_frac": 0.3, "max_indel": 6}
    return gen_panel.make(config, traffic, seed, str(tmp_path))


def test_panel_is_seeded(tmp_path):
    a, b, c = (tmp_path / x for x in "abc")
    for d in (a, b, c):
        d.mkdir()
    pa, pb, pc = (_tiny_panel(a, 2**40), _tiny_panel(b, 2**40),
                  _tiny_panel(c, 3))
    for k in ("fasta", "vcf"):
        assert open(pa[k], "rb").read() == open(pb[k], "rb").read()
        assert open(pa[k], "rb").read() != open(pc[k], "rb").read()
    recs = read_fasta(pa["fasta"])
    assert [len(s) for _, s in recs] == [3000, 2000]


def _brute_haplotype(ref: dict, vcf_path: str, sample: int, hap: int, w: int):
    """Per haplotype, by positions of a Python dict: the contig texts and
    text position -> marker."""
    contigs, _, recs = ref_panel.read_vcf(vcf_path)
    seqs, marks, start = [], {}, 0
    for cid, c in enumerate(contigs):
        out, last_end, after, bias = b"", 0, 0, 0
        for pos, alleles, gts in recs.get(c, ()):
            r = alleles[0]
            if pos < last_end:
                continue
            gt = 0 if sample < 0 else int(gts[sample, hap])
            a1 = alleles[1]
            base = start + bias + pos
            m = (gt << 60) | (cid << 46) | pos
            if len(r) == 1 and len(a1) == 1:
                span = [base]
            elif len(r) != len(a1) and gt == 0:
                span = list(range(base, base + len(r) + 1))
            elif len(r) > len(a1):
                span = [base, base + 1]
                bias -= len(r) - 1
            else:
                span = list(range(base, base + len(a1) + 1))
                bias += len(a1) - 1
            for p in span:
                assert p not in marks
                marks[p] = m
            out += ref[c][after:pos] + alleles[gt].encode()
            after = last_end = pos + len(r)
        out += ref[c][after:]
        seqs.append(out)
        start += len(ref[c]) + w + bias
    return seqs, marks


def test_panel_reference_matches_brute_force(tmp_path):
    w = 10
    inp = _tiny_panel(tmp_path, 5)
    fasta = read_fasta(inp["fasta"])
    ref = {n: s.tobytes() for n, s in fasta}
    seqs, pos, val, mps = ref_panel.panel(fasta, inp["vcf"], w)
    _, samples, _ = ref_panel.read_vcf(inp["vcf"])
    order = [(-1, 0)] + [(s, h) for s in range(len(samples)) for h in (0, 1)]
    want_seqs, marks, offset = [], {}, 0
    for s, h in order:
        hs, m = _brute_haplotype(ref, inp["vcf"], s, h, w)
        want_seqs += hs
        marks.update({p + offset: v for p, v in m.items()})
        offset += sum(len(x) + w for x in hs)
    assert [x.tobytes() for x in seqs] == want_seqs
    assert dict(zip(pos.tolist(), val.tolist())) == marks
    # .mps: maximal runs of adjacent positions with one marker
    words = mps.reshape(-1, 4)
    assert (words[:, 3] == ref_panel.DELIM).all()
    covered = {}
    for s, e, v, _ in words.tolist():
        for p in range(s, e + 1):
            covered[p] = v
    assert covered == marks
    for (s0, e0, v0, _), (s1, _, v1, _) in zip(words.tolist(),
                                               words[1:].tolist()):
        assert not (s1 == e0 + 1 and v1 == v0)
    # .ma: runs of adjacent SA rows over marked positions, by brute force
    text = collection_text(seqs, w)
    sa = torch.tensor(_brute_sa(text.tobytes()))
    ma = ref_panel.marker_array(sa, pos, val).reshape(-1, 4).tolist()
    rows = [(i, marks[s]) for i, s in enumerate(sa.tolist()) if s in marks]
    want = []
    for i, v in rows:
        if want and want[-1][1] == i - 1 and want[-1][2] == v:
            want[-1][1] = i
        else:
            want.append([i, i, v])
    assert [r[:3] for r in ma] == want


def test_k1_bytes_are_two_a_position():
    for n in (1, 67108944, 138411982):
        assert k1.bytes_moved(n) == 2 * n
        assert k1.least_seconds(n) == 2 * n / 3.35e12


def test_collection_text_pads_each_record(tmp_path):
    p = os.path.join(tmp_path, "x.fa")
    with open(p, "wb") as f:
        f.write(b">a desc\nAC\ngt\n>b\nT\n")
    recs = read_fasta(p)
    assert [(n, s.tobytes()) for n, s in recs] == [("a", b"ACGT"), ("b", b"T")]
    assert collection_text([s for _, s in recs], 3).tobytes() == b"ACGTAAATAAA"
