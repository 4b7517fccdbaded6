"""The port's multi-process parses (pfbwtf_tpu_torch/parallel/
multihost.py) in a 2-rank gloo world: ``multihost_parse`` (shard files
``.host0``/``.host1``, then rank 0's merge) and its ``main``, and
``multihost_union_parse`` (the collective dictionary rank).  Their files,
shard files included, equal those of pfbwtf_tpu's multihost_parse run as
two processes (its process index and count set in turn, on one
filesystem) and as one, of its single-process union parse, and of the
port's direct parse."""

import os

import numpy as np
import pytest

from tests.torch_worlds import run_world

SIZE = 2
W, P = 10, 10
PARSE_EXTS = ("dict", "occ", "parse", "n")
STAGE2_EXTS = ("bwlast", "ilist", "bwsai")


def _fasta(path):
    """Three records, so that the two ranks' record ranges differ."""
    seq = np.random.default_rng(23).choice(np.frombuffer(b"ACGT", np.uint8),
                                           size=8000).tobytes()
    with open(path, "wb") as f:
        f.write(b">r1\n" + seq[:2500] + b"\n>r2\n" + seq[2500:6000]
                + b"\n>r3\n" + seq[6000:] + b"\n")


def _world_cases(mesh, d):
    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.parallel.multihost import (
        init_distributed, main, multihost_parse, multihost_union_parse)

    fa = os.path.join(d, "in.fa")
    params = ParserParams(w=W, p=P, get_sai=True)
    got = multihost_parse(fa, os.path.join(d, "mh"), params, device="cpu")
    union = multihost_union_parse(fa, os.path.join(d, "mu"), params,
                                  device="cpu")
    rc = main([fa, "-o", os.path.join(d, "cli"), "-w", str(W), "-p",
               str(P), "-s"], device="cpu")
    return {"parse": got is not None, "union": union is not None, "rc": rc,
            "world": init_distributed(device="cpu")}


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    _fasta(d / "in.fa")
    ranks = run_world(SIZE, _world_cases, d / "world", args=(str(d),))
    return d, ranks


def _read(prefix, exts):
    out = {}
    for ext in exts:
        with open(f"{prefix}.{ext}", "rb") as f:
            out[ext] = f.read()
    return out


def test_world_results(world_dir):
    """Rank 0 alone returns the parses; every rank's main returns 0 and
    sees the world it runs in."""
    _, ranks = world_dir
    assert [r["parse"] for r in ranks] == [True, False]
    assert [r["union"] for r in ranks] == [True, False]
    assert [r["rc"] for r in ranks] == [0, 0]
    assert [r["world"] for r in ranks] == [(0, 2), (1, 2)]


def _jax_two_process_parse(d, monkeypatch):
    """pfbwtf_tpu's multihost_parse as its two processes run it on one
    filesystem: process 1 writes its shard, then process 0 writes its
    own and merges both."""
    import jax

    from pfbwtf_tpu.ops.parse import ParserParams
    from pfbwtf_tpu.parallel.multihost import multihost_parse

    params = ParserParams(w=W, p=P, get_sai=True)
    monkeypatch.setattr(jax, "process_count", lambda: SIZE)
    for pid in (1, 0):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        multihost_parse(str(d / "in.fa"), str(d / "jax2"), params,
                        barrier=False)


@pytest.mark.parametrize("prefix", ["mh", "cli"])
def test_multihost_parse_equals_jax(world_dir, monkeypatch, prefix):
    """Both shard files and the merged files, against pfbwtf_tpu's
    two-process run (``main`` with -s runs the same parse)."""
    d, _ = world_dir
    _jax_two_process_parse(d, monkeypatch)
    for shard in (".host0", ".host1"):
        assert _read(f"{d}/{prefix}{shard}", PARSE_EXTS) == \
            _read(f"{d}/jax2{shard}", PARSE_EXTS)
    exts = PARSE_EXTS + STAGE2_EXTS
    assert _read(f"{d}/{prefix}", exts) == _read(f"{d}/jax2", exts)


def test_multihost_parse_equals_direct_parse(world_dir):
    """The merged files equal pfbwtf_tpu's single-process multihost_parse
    (test_sharded.py's case) and the port's staged parse of the file."""
    from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
    from pfbwtf_tpu.parallel.multihost import multihost_parse
    from pfbwtf_tpu_torch.ops.parse import ParserParams
    from pfbwtf_tpu_torch.pipeline import run_parser

    d, _ = world_dir
    multihost_parse(str(d / "in.fa"), str(d / "jax1"),
                    JaxParams(w=W, p=P, get_sai=True), barrier=False)
    run_parser(str(d / "in.fa"), str(d / "direct"),
               ParserParams(w=W, p=P, get_sai=True), device="cpu")
    exts = PARSE_EXTS + STAGE2_EXTS
    got = _read(f"{d}/mh", exts)
    assert got == _read(f"{d}/jax1", exts)
    assert got == _read(f"{d}/direct", exts)


def test_multihost_union_parse_equals_jax(world_dir):
    from pfbwtf_tpu.ops.parse import ParserParams as JaxParams
    from pfbwtf_tpu.parallel.multihost import multihost_union_parse

    d, _ = world_dir
    multihost_union_parse(str(d / "in.fa"), str(d / "jaxu"),
                          JaxParams(w=W, p=P, get_sai=True))
    exts = PARSE_EXTS + STAGE2_EXTS
    got = _read(f"{d}/mu", exts)
    assert got == _read(f"{d}/jaxu", exts)
    assert got == _read(f"{d}/mh", exts)
