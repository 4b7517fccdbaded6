"""The port's CLI (``python -m pfbwtf_tpu_torch.cli.pfbwt_f --fused
[-m]``) writes the same bytes as the pfbwtf_tpu CLI."""

import numpy as np
import pytest

from pfbwtf_tpu.cli.pfbwt_f import main as jax_main
from pfbwtf_tpu_torch.cli.pfbwt_f import main as torch_main

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _fasta(path, seed=41):
    rng = np.random.default_rng(seed)
    unit = rng.choice(ACGT, size=1500)
    with open(path, "wb") as f:
        for i in range(3):
            hap = unit.copy()
            pos = rng.integers(0, hap.size, size=15)
            hap[pos] = ACGT[rng.integers(0, 4, size=15)]
            # lower case and 'N' exercise the normalization
            hap[:40] = np.frombuffer(b"acgtn" * 8, np.uint8)
            f.write(b">hap%d descr\n" % i)
            for j in range(0, hap.size, 70):
                f.write(hap[j: j + 70].tobytes() + b"\n")


@pytest.mark.parametrize("extra", [[], ["--u32"], ["-w", "6", "-p", "17"]])
def test_cli_fused_bytes_equal_jax(tmp_path, extra):
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["--fused", "-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), *args],
                      device="cpu") == 0
    for ext in ("bwt", "sa", "ssa", "esa"):
        want = (tmp_path / f"jax.{ext}").read_bytes()
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert len(want) > 0 and got == want, ext
    width = 4 if "--u32" in extra else 8
    n1 = len((tmp_path / "port.bwt").read_bytes())
    assert len((tmp_path / "port.sa").read_bytes()) == n1 * width


@pytest.mark.parametrize("extra", [[], ["--u32"]])
def test_cli_fused_stream_bytes_equal_jax_and_fused(tmp_path, extra):
    """--fused -m -s -r: the same files as the JAX CLI's --fused -m and as
    the port's own --fused."""
    fa = tmp_path / "in.fa"
    _fasta(fa)
    args = ["-s", "-r", *extra]
    assert jax_main([str(fa), "-o", str(tmp_path / "jax"), "--fused", "-m",
                     *args]) == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "port"), "--fused",
                       "-m", *args], device="cpu") == 0
    assert torch_main([str(fa), "-o", str(tmp_path / "mono"), "--fused",
                       *args], device="cpu") == 0
    for ext in ("bwt", "sa", "ssa", "esa"):
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert len(got) > 0
        assert got == (tmp_path / f"jax.{ext}").read_bytes(), ext
        assert got == (tmp_path / f"mono.{ext}").read_bytes(), ext


@pytest.mark.parametrize("args", [
    [], ["-m"], ["--fused", "-m", "--mesh"], ["--fused", "--mesh"],
    ["--fused", "--parse-only"],
    ["--fused", "--pfbwt-only"], ["--fused", "--print-docs"],
    ["--fused", "--device"], ["--fused", "--chunk-mb", "4"],
    ["--fused", "--shards", "2"], ["--fused", "--workers", "2"],
])
def test_cli_unported_modes_exit_1(tmp_path, args, capsys):
    fa = tmp_path / "in.fa"
    _fasta(fa)
    rc = torch_main([str(fa), "-o", str(tmp_path / "o"), *args], device="cpu")
    assert rc == 1
    assert "not ported" in capsys.readouterr().err


def test_cli_invalid_char_exits_1(tmp_path, capsys):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">x\nACGTBACGTACGTACGTACGT\n")
    rc = torch_main([str(fa), "-o", str(tmp_path / "o"), "--fused", "-p",
                     "3"], device="cpu")
    assert rc == 1
    assert "invalid character" in capsys.readouterr().err
