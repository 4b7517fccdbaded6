"""The pod parse (pfbwtf_tpu_torch/parallel/driver.py, ``pfbwt_f --shards
N [--workers K]``) against pfbwtf_tpu's: the same shard FASTAs, shard
parses, merged checkpoint files and final files, with the workers in a
spawn pool or in this process; the port's call leaves the environment
as it found it."""

import os

import numpy as np
import pytest

from pfbwtf_tpu.cli.pfbwt_f import main as jax_main
from pfbwtf_tpu.parallel.driver import split_fasta as jax_split
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main
from pfbwtf_tpu_torch.ops.parse import ParserParams
from pfbwtf_tpu_torch.parallel import driver

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _fasta(path, nrec=5, seed=90):
    """``nrec`` records of mutated copies of one unit, of unequal
    lengths, so that the byte-balanced split has work to do."""
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=1800)
    with open(path, "wb") as f:
        for i in range(nrec):
            hap = unit[: 900 + 200 * i].copy()
            pos = rng.integers(0, hap.size, size=12)
            hap[pos] = ACGT[rng.integers(0, 4, size=12)]
            f.write(b">rec%d\n" % i)
            for j in range(0, hap.size, 60):
                f.write(hap[j: j + 60].tobytes() + b"\n")


def _files_of(tmp_path, prefix):
    return {p.name[len(prefix):]: p.read_bytes()
            for p in tmp_path.iterdir() if p.name.startswith(prefix + ".")}


@pytest.mark.parametrize("nshards", [1, 2, 3, 5, 9])
def test_split_fasta_equals_jax(tmp_path, nshards):
    fa = tmp_path / "in.fa"
    _fasta(fa)
    got = driver.split_fasta(str(fa), nshards, str(tmp_path / "port"))
    want = jax_split(str(fa), nshards, str(tmp_path / "jax"))
    assert [os.path.basename(p)[4:] for p in got] == \
        [os.path.basename(p)[3:] for p in want]
    assert 1 <= len(got) <= min(nshards, 5)
    assert _files_of(tmp_path, "port") == _files_of(tmp_path, "jax")


def test_split_fasta_rejects_an_empty_file(tmp_path):
    (tmp_path / "e.fa").write_bytes(b"")
    with pytest.raises(ValueError, match="no records"):
        driver.split_fasta(str(tmp_path / "e.fa"), 2, str(tmp_path / "o"))


@pytest.mark.parametrize("shards,workers", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_cli_shards_equal_jax(tmp_path, monkeypatch, shards, workers):
    """pfbwt_f -s -r --shards N --workers K: every file of both CLIs'
    runs (shard FASTAs and parses, the merged checkpoint, the final
    files) is equal, and the port's run leaves os.environ unchanged."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", "--shards", str(shards), "--workers", str(workers)]
    env = dict(os.environ)
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    assert dict(os.environ) == env
    # pfbwtf_tpu's in-process worker sets PFBWT_BACKEND with setdefault
    monkeypatch.setenv("PFBWT_BACKEND", "numpy")
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    got, want = _files_of(tmp_path, "port"), _files_of(tmp_path, "jax")
    assert got == want
    for i in range(shards):
        for ext in ("fa", "dict", "occ", "parse", "n"):
            assert f".shard{i}.{ext}" in got
    for ext in ("bwt", "sa", "ssa", "esa", "bwlast", "ilist", "bwsai"):
        assert len(got["." + ext]) > 0


def test_cli_shards_with_docs_equal_whole_parse(tmp_path):
    """--shards 3 --print-docs: the merged checkpoint and final files
    equal the whole-array staged run's (.docs included)."""
    fa = tmp_path / "in.fa"
    _fasta(fa, nrec=6, seed=91)
    args = ["-s", "-r", "--print-docs", "--u32"]
    assert torch_main([str(fa), "-o", str(tmp_path / "pod"), "--shards", "3",
                       "--workers", "1", *args], device="cpu") == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "whole"), *args],
                      device="cpu") == 0
    pod, whole = _files_of(tmp_path, "pod"), _files_of(tmp_path, "whole")
    assert ".docs" in whole
    assert {k: v for k, v in pod.items() if ".shard" not in k} == whole


def test_pod_parse_info_and_parse_only(tmp_path):
    """The library call: stage seconds in ``info``, and --parse-only
    stops after the merged checkpoint files."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    info = {}
    res = driver.pod_parse(str(fa), str(tmp_path / "lib"),
                           ParserParams(w=10, p=100, get_sai=True),
                           nshards=2, workers=1, device="cpu", info=info)
    for key in ("split_s", "shards_s", "rebuild_s", "scan_s", "dedup_s",
                "parse_bwt_s", "write_s"):
        assert info[key] >= 0, key
    assert len(info["shard_s"]) == 2
    assert res.n == sum(900 + 200 * i + 10 for i in range(5))
    assert torch_main([str(fa), "-o", str(tmp_path / "po"), "--shards", "2",
                       "--workers", "1", "-s", "--parse-only"],
                      device="cpu") == 0
    files = _files_of(tmp_path, "po")
    assert ".bwsai" in files and ".bwt" not in files


def test_pool_workers_share_the_cores(tmp_path, monkeypatch):
    """pod_parse gives each of K spawn workers cores // K intra-op
    threads, and a worker's initialiser sets that count."""
    import torch

    seen = []
    run = driver.run_shards
    monkeypatch.setattr(driver, "run_shards", lambda jobs, workers, threads:
                        seen.append((workers, threads)) or run(jobs, 1, None))
    fa = tmp_path / "in.fa"
    _fasta(fa)
    driver.pod_parse(str(fa), str(tmp_path / "o"), ParserParams(w=10, p=100),
                     nshards=3, workers=3, device="cpu")
    cores = len(os.sched_getaffinity(0))
    assert seen == [(3, max(1, cores // 3))]
    before = torch.get_num_threads()
    try:
        driver._init_worker(1)
        assert torch.get_num_threads() == 1
    finally:
        torch.set_num_threads(before)


def test_pod_parse_default_device_raises_without_a_card(tmp_path,
                                                       monkeypatch):
    """The merge runs on the card unless the caller asks for the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "in.fa"
    _fasta(fa)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.pod_parse(str(fa), str(tmp_path / "o"), ParserParams(),
                         nshards=2, workers=1)
    assert not _files_of(tmp_path, "o")  # raised before the split
