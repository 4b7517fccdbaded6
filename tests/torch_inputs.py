"""Inputs that several of the port's test files share.  Made with numpy
and the port alone, so that a test file that needs no JAX loads none."""

import numpy as np

from pfbwtf_tpu_torch.engine import parse_records
from pfbwtf_tpu_torch.ops.fused import _bucket
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.ops.parse_bwt import bwt_of_parse

ACGT = np.frombuffer(b"ACGT", np.uint8)
# every byte class the tables tell apart: upper and lower nucleotides,
# N/n and '-' (hashed as A and T), other letters of either case, digits,
# punctuation, and bytes past ASCII that toupper leaves alone
MIXED = np.frombuffer(b"ACGTacgtNn-BbxZz09*@[`{\x00\x7f\x80\xc1\xe1\xff",
                      np.uint8)


def records(name):
    """(records, w, p), the inputs of tests/test_fused.py:48-67 and
    132-158.  ``random``: 7,000 random bases.  ``repeats``: ten copies of
    a 700-base unit with 25 SNPs; the duplicate phrases leave many dict
    suffixes with nothing to emit (zero counts)."""
    rng = np.random.default_rng(21)
    if name == "random":
        return [("s", rng.choice(ACGT, size=7000))], 4, 10
    rng.choice(ACGT, size=6000)
    rep = np.tile(rng.choice(ACGT, size=700), 10)
    muts = rng.integers(0, rep.size, size=25)
    rep[muts] = ACGT[rng.integers(0, 4, size=25)]
    return [("r", rep)], 4, 12


def repeat_dict(seed=70, nwords=1500, w=10):
    """A dict-shaped byte array whose words are substrings of one random
    unit: long shared prefixes, so the doubling takes several rounds and
    many lanes stay unresolved at first.  EndOfWord after each word, the
    EndOfDict terminator and pads to the bucket grid."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=2000)
    parts = []
    for _ in range(nwords):
        s = int(rng.integers(0, 1900))
        parts.append(unit[s: s + int(rng.integers(w + 1, 90))])
        parts.append(np.ones(1, np.uint8))
    flat = np.concatenate(parts + [np.zeros(1, np.uint8)])
    out = np.zeros(_bucket(flat.shape[0]), np.uint8)
    out[: flat.shape[0]] = flat
    return out


def stage3_inputs(seed=22, size=5000, w=4, p=9):
    """(dict, w, occs, bwlast, ilist, bwsai, n): the staged build's stage
    3 inputs of one random record, those of tests/test_fused.py:165-177."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(ACGT, size=size)
    res = parse_records([("s", seq)], ParserParams(w=w, p=p, get_sai=True),
                        device="cpu")
    pb = bwt_of_parse(res.parse_ranks, res.last, res.sai, get_sai=True)
    return (res.dict_flat(), w, res.occs.astype(np.int64), pb.bwlast,
            pb.ilist, pb.bwsai, res.n)
