"""The benchmark's plain reference of the staged build's seven checkpoint
files (pfbench/reference/pfp.py, which imports neither package) against
the port's staged CLI and pfbwtf_tpu's, byte for byte."""

import numpy as np
import pytest

from pfbench.reference import pfp
from pfbench.reference.text import collection_text, read_fasta
from pfbwtf_tpu.cli.pfbwt_f import main as jax_main
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main

ACGT = np.frombuffer(b"ACGT", np.uint8)
# the files' widths in the default (64-bit) build
DTYPES = {"dict": np.uint8, "occ": np.uint64, "parse": np.uint32,
          "n": np.uint8, "bwlast": np.uint8, "ilist": np.uint64,
          "bwsai": np.uint64}


def _fasta(path, seed, unit_len, copies, snps, odd):
    """``copies`` records of one random unit with ``snps`` substitutions
    each, wrapped at 60; with ``odd``, lower case, 'N' and '-' in the
    first record and a record of another length."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=unit_len)
    with open(path, "wb") as f:
        for i in range(copies):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=snps)
            hap[pos] = ACGT[rng.integers(0, 4, size=snps)]
            if odd and i == 0:
                hap[100:140] = np.frombuffer(b"acgtN-" * 6 + b"nnnn", np.uint8)
            if odd and i == copies - 1:
                hap = hap[: unit_len // 3]
            f.write(b">r%d some words\n" % i)
            for j in range(0, hap.size, 60):
                f.write(hap[j: j + 60].tobytes() + b"\n")


@pytest.mark.parametrize("seed, w, p, unit_len, copies, snps, odd", [
    (11, 10, 100, 4000, 4, 20, False),  # the configuration's w and p
    (12, 4, 5, 1500, 3, 10, True),  # a small p: a phrase every few bases
    (13, 6, 17, 2500, 5, 40, True),
    (14, 10, 100, 6000, 2, 0, False),  # identical records
])
def test_reference_files_equal_both_packages(tmp_path, seed, w, p, unit_len,
                                             copies, snps, odd):
    fa = tmp_path / "in.fa"
    _fasta(fa, seed, unit_len, copies, snps, odd)
    args = ["-s", "-r", "-w", str(w), "-p", str(p), "--parse-only"]
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    seqs = [s for _, s in read_fasta(str(fa))]
    want = pfp.checkpoint_files(collection_text(seqs, w), w, p, "cpu")
    assert set(want) == set(DTYPES)
    assert int((tmp_path / "port.parse").stat().st_size) > 40
    for ext, dt in DTYPES.items():
        ref = want[ext].numpy().astype(dt).tobytes()
        assert (tmp_path / f"port.{ext}").read_bytes() == ref, ext
        assert (tmp_path / f"jax.{ext}").read_bytes() == ref, ext


def test_reference_hash_refuses_what_the_hasher_cannot_take():
    text = np.frombuffer(b"ACGTACGTACGTB", np.uint8)
    with pytest.raises(ValueError, match="66"):
        pfp.cut_positions(text, 4, 3, "cpu")


def test_control_breaks_only_the_parse_bwt():
    """The reference with its suffix sort stopped after one round: the
    parse files stay, the parse-BWT's order does not."""
    rng = np.random.default_rng(9)
    unit = rng.choice(ACGT, size=3000)
    text = collection_text([unit, unit, unit], 4)
    want = pfp.checkpoint_files(text, 4, 7, "cpu")
    ctrl = pfp.checkpoint_files(text, 4, 7, "cpu", max_rounds=1)
    for ext in ("dict", "occ", "parse", "n"):
        assert torch_equal(want[ext], ctrl[ext]), ext
    assert not torch_equal(want["ilist"], ctrl["ilist"])


def torch_equal(a, b):
    return a.shape == b.shape and bool((a == b).all())
