"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m pfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Everything is found by name: the cell in
BENCHMARK.json, its configuration (``pfbench/configs/<config>.json``), its
traffic (``pfbench/traffic/<traffic>.json``, read by
``pfbench/generators/<generator>.py``), the driver of the configuration's
entry (``pfbench/drivers/<entry>.py``) and one reader per per-layer metric
(``pfbench/metrics/<metric>.py``).

A run: set-up (imports, the card, the inputs from the seed under TMPDIR,
one warm build), then builds back to back on the same input until the
window's seconds have passed and the build in flight is done, then the
check: the plain reference works out the outputs again and every number
compared is printed beside its limit, last on stderr and last in the
result line. With ``--trace 1`` one torch.profiler run covers the window
and the result holds the per-layer metrics and the breakdown, else the
end-to-end metrics. The last line of stdout is the result, as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "pfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "pfbwtf_tpu")
GIB = float(1 << 30)


class NoCard(RuntimeError):
    pass


def load_cell(workload: str, overrides: dict = None):
    """(cell, config, traffic, manifest) of ``workload``, the files found
    by name; ``overrides`` replaces keys of the config and the traffic
    (the tests' tiny sizes). The config holds the scale, the traffic the
    data model; the generator reads both."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    with open(os.path.join(HERE, "configs", cell["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return cell, config, traffic, manifest


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"this cell needs {chips} CUDA card(s); found "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def tree_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "pfbench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host-clock seconds by span name for the build in progress, and a
    ``record_function`` range of ``pfbench.<name>`` when traced."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds = {}

    @contextmanager
    def __call__(self, name: str):
        import torch

        rf = (torch.profiler.record_function("pfbench." + name)
              if self.traced else nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None) -> dict:
    """One run of a cell; returns the result (without printing it)."""
    cell, config, traffic, manifest = load_cell(workload, overrides)
    on_card = device == "cuda"
    if on_card:
        require_cards(int(cell["chips"]))
    import numpy as np
    import torch

    from pfbwtf_tpu_torch.ops import suffix
    from pfbwtf_tpu_torch.ops.cuda import hash_scan
    from pfbwtf_tpu_torch.utils.malloc_tuning import tune_malloc

    from . import trace as tracing

    tune_malloc()
    if on_card:
        torch.cuda.init()
    gen = importlib.import_module(f"pfbench.generators.{traffic['generator']}")
    drv = importlib.import_module(f"pfbench.drivers.{config['entry']}")
    workdir = tempfile.mkdtemp(prefix="pfbench-")
    try:
        inputs = gen.make(config, traffic, seed, workdir)
        driver = drv.Driver(config, inputs, workdir, device)
        driver.build(-1, Spans(False))  # the warm build, at the cell's size
        driver.release(-1)
        sync(device)
        setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        picked = int(np.random.default_rng([seed, 1]).integers(0, 3))
        kept, builds = {}, []
        driver.keep = {picked}
        hash_scan.launches = 0
        prof = tracing.profiler() if trace else None
        setup_s = time.perf_counter() - T_START
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        with (torch.profiler.record_function(tracing.WINDOW) if trace
              else nullcontext()):
            i = 0
            while True:
                spans = Spans(trace)
                c0 = time.process_time()
                res, info = driver.build(i, spans)
                builds.append({"info": info, "spans": spans.seconds,
                               "cpu_s": time.process_time() - c0})
                done = time.perf_counter() - t0 >= seconds
                # the picked build and the last are checked; no other
                # result outlives the next build, as in one CLI run
                if i == picked or done:
                    kept[i] = res
                del res
                i += 1
                if done:
                    break
            sync(device)
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        launches, rounds = hash_scan.launches, dict(suffix.rounds)
        got = {k: driver.outputs(k, r) for k, r in kept.items()}
        del kept
        traced = tracing.summarize(prof, workdir) if prof is not None else {}
        del prof
        if on_card:
            torch.cuda.empty_cache()
        want, sizes = drv.reference(config, inputs, device)
        numbers = {}
        for k in sorted(got):
            for name, v in drv.check(got[k], want).items():
                numbers[f"build{k}.{name}"] = {"value": v, "limit": 0}
        written = tree_bytes(workdir) + driver.released_bytes
        del got, want, driver
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    failed_builds = {k.split(".")[0] for k, v in numbers.items()
                     if v["value"] > v["limit"]}
    correct = bool(numbers) and not failed_builds
    print(f"card: {card_line() if on_card else device}", file=sys.stderr)
    print(f"builds in the window: {len(builds)} in {window_s:.6f} s; "
          f"K1 launches {launches}; doubling rounds of the last build "
          f"{rounds}; reference rounds {sizes['rounds']}; text n "
          f"{sizes['text_n']}, bases {sizes['bases']}; files written "
          f"{written} bytes, trace {traced.get('trace_bytes', 0)} bytes",
          file=sys.stderr)
    print("build seconds: " + " ".join(
        f"{sum(b['spans'].values()):.4f}" for b in builds), file=sys.stderr)
    # each build's stages and the process's CPU seconds in it: where CPU
    # seconds follow the wall, the host ran slower, not idle
    for i, b in enumerate(builds):
        stages = {k: v for k, v in b["info"].items()
                  if k.endswith("_s") and isinstance(v, float)}
        stages["cpu_s"] = b["cpu_s"]
        print(f"build {i}: " + " ".join(
            f"{k} {v:.4f}" for k, v in stages.items()), file=sys.stderr)
    if trace:
        ctx = {"builds": builds, "trace": traced, "text_n": sizes["text_n"],
               "bases": sizes["bases"], "window_s": window_s}
        metrics = {}
        for m in manifest["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {
            "build_mbps": sizes["bases"] * len(builds) / window_s / 1e6,
            "peak_dev_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest["end_to_end"]
                   if workload in m.get("workloads", [workload])}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(cell["chips"]),
           "memory_peak_bytes": max(setup_peak, peak)}
    if trace:
        dev["busy_s"] = traced.get("busy_s", 0.0)
        dev["window_s"] = traced.get("window_s", window_s)
    result = {"correct": correct, "attempted": len(builds),
              "failed": len(failed_builds), "metrics": metrics,
              "device": dev}
    if trace and traced:
        result["breakdown"] = traced["breakdown"]
    result["checks"] = numbers
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoCard as e:
        print(f"pfbench: {e}", file=sys.stderr)
        return 2
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"pfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
