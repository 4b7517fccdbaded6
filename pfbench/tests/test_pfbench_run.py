"""Whole runs of each cell at tiny sizes on the CPU: the control flow, the
check against a broken timed path, the control, and the import boundary.
The card's own run is marked ``card``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pfbench import control, run

from .conftest import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = sorted(TINY)


def _run(cell, seed=2**35 + 3, trace=False, device="cpu"):
    return run.run_cell(cell, seed, 0.2, trace, device=device,
                        overrides=TINY[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_walk_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in run.load_cell(cell)[3]["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want and "setup_s" in want
    assert r["checks"] and all(v["value"] == 0 for v in r["checks"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_walk_reads_the_program_spans(cell):
    r = _run(cell, trace=True)
    assert r["correct"]
    want = {m["name"] for m in run.load_cell(cell)[3]["per_layer"]
            if m["source"] in ("program_span", "host_clock")
            and cell in m["workloads"]}
    assert want and want <= set(r["metrics"])
    # no card: the device readers find nothing and say nothing
    assert "k1_roofline" not in r["metrics"]
    assert "device.idle_pct" not in r["metrics"]


def _alter_answer(res):
    res.bwt[len(res.bwt) // 2] ^= 1
    return res


FAULTS = {
    # a token or an answer altered where it is produced
    "answer": lambda records: (records, _alter_answer),
    # half of the batch left out
    "half": lambda records: (records[: len(records) // 2], None),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import pfbwtf_tpu_torch.ops.fused as fused

    build = fused.pfbwt_fused_records

    def broken(records, params, **kw):
        records, after = FAULTS[fault](list(records))
        res, info = build(records, params, **kw)
        return (after(res) if after else res), info

    monkeypatch.setattr(fused, "pfbwt_fused_records", broken)
    r = _run(cell)
    assert not r["correct"] and r["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    for seed in (1, 2, 3):
        r = control.control_numbers(cell, seed, device="cpu",
                                    overrides=TINY[cell])
        assert not r["correct"], r


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "pfbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


_BOUNDARY = r"""
import json, sys
sys.path.insert(0, {root!r})
from pfbench import run
run.run_cell({cell!r}, 7, 0.1, {trace}, device="cpu", overrides={tiny!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = _BOUNDARY.format(root=ROOT, cell=cell, trace=True,
                            tiny=TINY[cell])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json\n"
            "import pfbench.reference.sa, pfbench.reference.panel, "
            "pfbench.reference.text, pfbench.compare, pfbench.counts.k1\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "pfbwtf_tpu",
                         "pfbwtf_tpu_torch"}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_walk_is_correct(card, cell):
    r = _run(cell, device=card, trace=True)
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["k1_roofline"]["value"] <= 100
    assert 0 <= r["metrics"]["device.idle_pct"]["value"] < 100
    assert np.isfinite(r["device"]["memory_peak_bytes"])
