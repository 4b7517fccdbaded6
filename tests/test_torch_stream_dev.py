"""The fused build's char stream built on the device
(``ops/fused.stream_dev``) on the CPU: its bytes against the JAX
package's and the port's host ``build_stream`` followed by the 'A'
bucket pad, its check against the message of the JAX package's fused
build and of ``codes_or_die``, the operations it runs against the number
of records, and the build's counters."""

import io
import shutil
from collections import Counter
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from pfbwtf_tpu.ops import fused as jfused
from pfbwtf_tpu.ops.parse import ParserParams as JParams
from pfbwtf_tpu.ops.parse import build_stream as jbuild_stream
from pfbwtf_tpu.utils.errors import PfbwtError as JPfbwtError
from pfbwtf_tpu.utils.tables import NTOA_TABLE as JNTOA_TABLE
from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
from pfbwtf_tpu_torch.ops import fused
from pfbwtf_tpu_torch.ops.fused_stream import pfbwt_fused_stream_records
from pfbwtf_tpu_torch.ops.parse import ParserParams, build_stream
from pfbwtf_tpu_torch.utils.errors import PfbwtError
from pfbwtf_tpu_torch.utils.tables import codes_or_die, die_invalid
from pfbwtf_tpu_torch.vcf.pipeline import VcfToBwtConfig, vcf_to_bwt

from .ref_fixtures import random_fasta
from .torch_inputs import MIXED
from .vcf_gen import random_vcf

ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")
# operations that make a view of a tensor or of a host array, no launch
VIEWS = {"aten::slice", "aten::as_strided", "aten::lift_fresh",
         "aten::alias", "aten::detach", "aten::view"}


def _records(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "one":
        return [("s", rng.choice(MIXED, size=5000))]
    if name == "mixed":
        return [(f"r{i}", rng.choice(MIXED, size=n))
                for i, n in enumerate((1200, 7, 3000))]
    if name == "empty_among":
        return [("a", rng.choice(MIXED, size=900)),
                ("b", np.zeros(0, np.uint8)),
                ("c", rng.choice(MIXED, size=1100))]
    # many300: 300 short records, runs of lowercase and of N among them
    seqs = []
    for i in range(300):
        seq = rng.choice(ACGT, size=int(rng.integers(0, 40)))
        if i % 3 == 0:
            seq = seq + 32  # lowercase acgt
        if i % 7 == 0:
            seq[: seq.size // 2] = ord("N")
        seqs.append((f"r{i}", seq))
    return seqs


def _stream_dev(records, params):
    """(chars, C_len, check) as pfbwt_fused_records builds them."""
    seqs = [np.asarray(s, np.uint8) for _, s in records]
    C_len = sum(s.shape[0] for s in seqs) + params.w * len(seqs)
    n_b = fused._bucket(max(C_len, 1), 1 << 16)
    chars, check = fused.stream_dev(seqs, params, n_b, CPU)
    return chars.numpy(), C_len, check.tolist()


def _message(fn):
    with pytest.raises((PfbwtError, JPfbwtError)) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("w", [4, 10])
@pytest.mark.parametrize("to_a", [False, True])
@pytest.mark.parametrize("name", ["one", "mixed", "empty_among", "many300"])
def test_device_chars_equal_build_stream(name, to_a, w):
    records = _records(name)
    params = ParserParams(w=w, p=10, non_acgt_to_a=to_a)
    jparams = JParams(w=w, p=10, non_acgt_to_a=to_a)
    C, _, _ = jbuild_stream(records, jparams)
    assert build_stream(records, params)[0].tobytes() == C.tobytes()
    chars, C_len, (bad, byte) = _stream_dev(records, params)
    assert C_len == C.shape[0]
    assert chars.shape[0] == fused._bucket(max(C_len, 1), 1 << 16)
    assert chars[:C_len].tobytes() == C.tobytes()
    assert (chars[C_len:] == ord("A")).all()
    # MIXED holds invalid bytes; many300 and --non-acgt-to-a none
    assert bad == (not to_a and name != "many300")
    # the JAX build checks C before it parses, so it dies at once
    assert bad == (JNTOA_TABLE[C].max(initial=0) > 3)
    if bad:
        assert _message(lambda: die_invalid(byte)) == \
            _message(lambda: jfused.pfbwt_fused_records(records, jparams))


def test_stream_dev_launches_but_copies_do_not_grow_with_records():
    """300 records add one copy each (and its views) to one record's
    operations: the pad and tail fills, the normalization and the check
    are the same launches."""
    from torch.profiler import ProfilerActivity, profile

    ops = []
    for records in (_records("one"), _records("many300")):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _stream_dev(records, ParserParams(w=10, p=10,
                                              non_acgt_to_a=True))
        ops.append(Counter(e.name for e in prof.events()
                           if e.name.startswith("aten::")))
    grown = ops[1] - ops[0]
    assert ops[0]["aten::index_fill_"] == ops[1]["aten::index_fill_"] == 1
    assert grown["aten::copy_"] == 299
    assert set(grown) - {"aten::copy_"} <= VIEWS


def _bad_records(case):
    rng = np.random.default_rng(91)
    seqs = [rng.choice(ACGT, size=400) for _ in range(3)]
    p = 10
    if case == "upper":
        seqs[0][57] = ord("B")
    elif case == "lower":
        seqs[1][3] = ord("b")  # uppercased first: reported as 66/B
        seqs[2][9] = ord("Q")
    elif case == "third_record":
        seqs[2][200:203] = np.frombuffer(b"n-*", np.uint8)
        seqs[2][300] = ord("E")
    else:  # single_phrase: no cut either, but the bad byte wins
        seqs = [np.full(50, ord("A"), np.uint8), np.full(8, ord("A"),
                                                         np.uint8)]
        seqs[1][5] = ord("x")
        p = (1 << 20) - 1
    return [(f"r{i}", s) for i, s in enumerate(seqs)], ParserParams(w=4, p=p)


@pytest.mark.parametrize("entry", ["records", "device"])
@pytest.mark.parametrize("case", ["upper", "lower", "third_record",
                                  "single_phrase"])
def test_invalid_byte_dies_as_codes_or_die(case, entry):
    """The message of the JAX package's fused build, whose host check
    runs before its parse, and of ``codes_or_die`` on the same stream."""
    records, params = _bad_records(case)
    C, _, _ = build_stream(records, params)
    want = _message(lambda: jfused.pfbwt_fused_records(
        records, JParams(w=params.w, p=params.p)))
    assert want == _message(lambda: codes_or_die(C))
    assert want.startswith("invalid character ")
    if case == "lower":
        assert "66/B" in want
    if entry == "records":
        got = _message(lambda: fused.pfbwt_fused_records(
            records, params, device="cpu"))
    else:
        got = _message(lambda: fused.pfbwt_fused_device(
            C, params.w, params.p, device="cpu"))
    assert got == want


def _fixed_fused():
    rng = np.random.default_rng(71)
    unit = rng.choice(ACGT, size=2000)
    records = []
    for i in range(4):
        seq = unit.copy()
        seq[rng.integers(0, seq.size, 10)] = rng.choice(ACGT, 10)
        records.append((f"h{i}", seq))
    return records, ParserParams(w=6, p=20)


def _counts_fused(tmp_path):
    records, params = _fixed_fused()
    return fused.pfbwt_fused_records(records, params, device="cpu",
                                     want_sa=True, want_rssa=True)[1]


def _counts_vcf(tmp_path):
    rng = np.random.default_rng(72)
    fa = random_fasta(str(tmp_path / "ref.fa"), rng, nrecords=2, length=1200)
    vcf = str(tmp_path / "p.vcf")
    random_vcf(vcf, read_fasta_bytes(fa), rng, nsamples=2, density=0.02,
               indel_frac=0.3)
    shutil.copy(fa, tmp_path / "own.fa")
    info = {}
    vcf_to_bwt(VcfToBwtConfig(
        fasta=str(tmp_path / "own.fa"), vcfs=[vcf],
        output=str(tmp_path / "out"), mod=10, rssa=True, ma=True, fused=True,
        device="cpu"), info)
    return info


def _counts_stream(tmp_path):
    records, params = _fixed_fused()
    bufs = {e: io.BytesIO() for e in ("bwt", "sa", "ssa", "esa")}
    return pfbwt_fused_stream_records(
        records, params, open_out=lambda e: nullcontext(bufs[e]),
        want_sa=True, want_rssa=True, device="cpu")[1]


@pytest.mark.parametrize("build", ["fused", "vcf", "stream"])
def test_stream_dev_counter(build, tmp_path):
    """One ``stream_dev`` a build whose stream the device built, none on
    the streamed build; the fixed fused build's reads: as many syncs as
    the host stream gave, and 16 bytes more, the check's pair."""
    info = {"fused": _counts_fused, "vcf": _counts_vcf,
            "stream": _counts_stream}[build](tmp_path)
    counts = info["counts"]
    if build == "stream":
        assert "stream_dev" not in counts
        return
    assert counts["stream_dev"] == 1
    assert "j2.upload" not in {s[0] for s in info["spans"]}
    if build == "fused":
        assert (counts["syncs"], counts["d2h_bytes"]) == (17, 128601 + 16)
