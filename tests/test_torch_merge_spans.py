"""merge_pfp as one build (its spans, counters and ``*_s`` keys), and the
merge of per-haplotype parses against the benchmark's plain reference
(pfbench/reference: pfp.py, merge.py, sa.py, which import neither
package): the merged checkpoint files and ``.docs``, then the four
outputs of ``pfbwt_f --pfbwt-only``, byte for byte.  The port runs with
device="cpu"."""

import os

import numpy as np
import pytest
import torch

from pfbench.reference import merge as ref_merge
from pfbench.reference import pfp
from pfbench.reference import sa as ref_sa
from pfbench.reference.text import collection_text, read_fasta
from pfbwtf_tpu_torch.cli import merge_pfp, pfbwt_f

ACGT = np.frombuffer(b"ACGT", np.uint8)
SPANS = ["merge.rebuild", "merge.scan", "merge.dedup", "merge.save_parse",
         "staged.parse_bwt", "staged.save_parse_bwt"]
CKPT = {"dict": np.uint8, "occ": np.uint64, "parse": np.uint32,
        "n": np.uint8, "bwlast": np.uint8, "ilist": np.uint64,
        "bwsai": np.uint64}
OUTS = {"bwt": np.uint8, "sa": np.uint64, "ssa": np.uint64,
        "esa": np.uint64}


def _haplotypes(tmp_path, seed, nshards, unit_len, snps, wrap=0):
    """One FASTA a shard of 1-2 records each, mutated copies of one random
    unit (so the shards share phrases); lines wrapped at ``wrap``."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    paths = []
    for i in range(nshards):
        path = tmp_path / f"hap{i}.fa"
        with open(path, "wb") as f:
            for r in range(int(rng.integers(1, 3))):
                hap = unit[: unit_len - int(rng.integers(0, unit_len // 4))]
                hap = hap.copy()
                hap[rng.integers(0, hap.size, size=snps)] = ACGT[
                    rng.integers(0, 4, size=snps)]
                f.write(b">h%d_%d sample\n" % (i, r))
                step = wrap or hap.size
                for j in range(0, hap.size, step):
                    f.write(hap[j: j + step].tobytes() + b"\n")
        paths.append(str(path))
    return paths


def _shard_parses(tmp_path, fastas, w, p):
    """Each FASTA parsed as vcf_to_bwt.py parses a haplotype
    (--parse-only --print-docs -s); returns the prefixes."""
    prefixes = []
    for i, fa in enumerate(fastas):
        prefix = str(tmp_path / f"shard{i}")
        assert pfbwt_f.main(["--parse-only", "--print-docs", "-s", "-w",
                             str(w), "-p", str(p), "-o", prefix, fa],
                            device="cpu") == 0
        prefixes.append(prefix)
    return prefixes


def _merge(prefixes, out, w, p, extra=(), info=None):
    return merge_pfp.main([*prefixes, "-o", out, "-s", "--parse-bwt",
                           "--docs", "-w", str(w), "-p", str(p), *extra],
                          device="cpu", info=info)


def test_merge_pfp_is_one_build(tmp_path):
    fastas = _haplotypes(tmp_path, 3, 4, 2000, 12)
    prefixes = _shard_parses(tmp_path, fastas[:3], 10, 10)
    prefixes.append(fastas[3])  # a FASTA, read and not rebuilt
    info = {}
    out = str(tmp_path / "m")
    assert _merge(prefixes, out, 10, 10, info=info) == 0
    names = [s[0] for s in info["spans"]]
    assert names == SPANS
    assert all(s[1] is None for s in info["spans"])
    secs = {s[0]: s[3] - s[2] for s in info["spans"]}
    for key, name in (("rebuild_s", "merge.rebuild"),
                      ("scan_s", "merge.scan"), ("dedup_s", "merge.dedup"),
                      ("parse_bwt_s", "staged.parse_bwt")):
        assert info[key] == secs[name], key
    assert info["write_s"] == pytest.approx(
        secs["merge.save_parse"] + secs["staged.save_parse_bwt"])
    counts = info["counts"]
    assert counts["merge_prefixes"] == 4
    rebuilt = sum(int(open(p + ".n").read()) for p in prefixes[:3])
    assert counts["rebuilt_bytes"] == rebuilt
    written = ("dict", "occ", "parse", "n", "docs", "bwlast", "ilist",
               "bwsai")
    assert counts["ckpt_bytes"] == sum(
        os.path.getsize(f"{out}.{ext}") for ext in written)
    # the cut positions, the dedup's ranks, the parse-BWT's four reads
    assert counts["syncs"] >= 6 and counts["d2h_bytes"] > 0
    assert "peak_merge" in info and info["peak_merge"] is None  # no card
    assert isinstance(info["build_id"], int)


@pytest.mark.parametrize("extra, plain", [([], []), (["-t", "4"], []),
                                          (["--u32"], ["--u32"])])
def test_merge_pfp_files_do_not_depend_on_info(tmp_path, extra, plain):
    """A run that hands back ``info`` writes the bytes of one that does
    not, and -t changes nothing."""
    prefixes = _shard_parses(tmp_path, _haplotypes(tmp_path, 4, 3, 1500, 8),
                             10, 10)
    assert _merge(prefixes, str(tmp_path / "a"), 10, 10, extra,
                  info={}) == 0
    assert _merge(prefixes, str(tmp_path / "b"), 10, 10, plain) == 0
    for ext in ("dict", "occ", "parse", "n", "docs", "bwlast", "ilist",
                "bwsai"):
        assert ((tmp_path / f"a.{ext}").read_bytes()
                == (tmp_path / f"b.{ext}").read_bytes()), ext


def test_two_runs_are_two_builds(tmp_path):
    """Two runs are two builds: no span of the first reaches the second."""
    prefixes = _shard_parses(tmp_path, _haplotypes(tmp_path, 6, 2, 1200, 5),
                             10, 10)
    first, second = {}, {}
    assert _merge(prefixes, str(tmp_path / "a"), 10, 10, info=first) == 0
    assert _merge(prefixes, str(tmp_path / "b"), 10, 10, info=second) == 0
    assert [s[0] for s in second["spans"]] == SPANS
    assert second["build_id"] != first["build_id"]
    assert second["counts"] == first["counts"]


@pytest.mark.parametrize("seed, nshards, w, p, unit_len, snps, wrap", [
    (21, 8, 10, 100, 3000, 6, 0),  # the configuration's w, p and shards
    (22, 4, 10, 10, 1500, 10, 60),
    (23, 5, 6, 17, 1200, 20, 0),
    (24, 6, 4, 5, 800, 4, 70),  # a phrase every few bases
])
def test_merged_files_equal_the_plain_reference(tmp_path, seed, nshards, w,
                                                p, unit_len, snps, wrap):
    fastas = _haplotypes(tmp_path, seed, nshards, unit_len, snps, wrap)
    prefixes = _shard_parses(tmp_path, fastas, w, p)
    out = str(tmp_path / "m")
    assert _merge(prefixes, out, w, p) == 0
    assert pfbwt_f.main(["--pfbwt-only", "-s", "-r", "-w", str(w), "-p",
                         str(p), "-o", out], device="cpu") == 0
    records = [r for fa in fastas for r in read_fasta(fa)]
    text = collection_text([s for _, s in records], w)
    want = pfp.checkpoint_files(text, w, p, "cpu")
    for ext, dt in CKPT.items():
        ref = want[ext].numpy().astype(dt).tobytes()
        assert open(f"{out}.{ext}", "rb").read() == ref, ext
    assert (open(f"{out}.docs", "rb").read()
            == ref_merge.docs_file(records, w).tobytes())
    sa, _ = ref_sa.suffix_array(text, "cpu")
    bwt = ref_sa.bwt_of(torch.from_numpy(text), sa)
    ssa, esa = ref_sa.run_samples(bwt, sa)
    for ext, t in (("bwt", bwt), ("sa", sa), ("ssa", ssa), ("esa", esa)):
        ref = t.numpy().astype(OUTS[ext]).tobytes()
        assert open(f"{out}.{ext}", "rb").read() == ref, ext


def test_docs_reference_counts_each_record_and_its_pad():
    recs = [("a", np.zeros(5, np.uint8)), ("b", np.zeros(3, np.uint8)),
            ("c", np.zeros(0, np.uint8))]
    assert ref_merge.docs_file(recs, 10).tobytes() == b"a 0\nb 15\nc 28\n"
