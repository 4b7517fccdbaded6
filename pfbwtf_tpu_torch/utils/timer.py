"""Stage spans, per-build counters, and the TASK lines built on them.

``span(name)`` times a stage on ``time.perf_counter``.  While a
``torch.profiler`` run is recording (the caller's, or the one that
``PFBWT_PROFILE`` starts) it is also a ``record_function`` range named
``pfbwt.<name>``, so the stage sits on the clock of the kernels and
copies it launched; with no profiler it costs a clock pair and a flag
check.

``build(info)`` opens a build at an entry point
(``ops/fused.pfbwt_fused_records`` and ``pfbwt_fused_device``,
``vcf/pipeline.vcf_to_bwt``); an entry point called inside an open build
joins it.  While a build is open on this thread, each closed span is kept
as ``(name, parent, t0, t1)``, ``parent`` the index in the same list of
the innermost span open around it (None at the top); ``count(name, n)``
adds to the build's counters.  When the outermost entry point returns,
the list is ``info["spans"]``, the counters ``info["counts"]`` and the
build's number ``info["build_id"]``.  A span's self time is its duration
less what its children cover.  ``host_read`` is ``.cpu()`` counted as
one of the build's ``syncs`` and its bytes as ``d2h_bytes``.

``task_timer(label)`` prints ``TASK\\t<label>\\t<sec>`` on stderr, the
text contract of the reference's RAII Timer (pfbwt-f.cpp:35-50); under a
profiler the stage is also a range named by the label, and given a
``name`` it is a span of that name too.  With ``PFBWT_PROFILE=<dir>`` the
first task starts one ``torch.profiler`` run over the rest of the process
(CPU, and CUDA where a card is present) and the Chrome trace goes to
``<dir>/pfbwt_<pid>.json`` at exit.
"""

import atexit
import itertools
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

_profiler = None  # the process-wide profiler, once PFBWT_PROFILE starts it
_build_ids = itertools.count()


class _Local(threading.local):
    build = None  # the open build of this thread


_local = _Local()


def _profiling() -> bool:
    """Whether a torch.profiler run is recording; without torch imported
    none can be."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class _Build:
    __slots__ = ("id", "spans", "stack", "counts")

    def __init__(self):
        self.id = next(_build_ids)
        self.spans = []  # in the order they opened
        self.stack = []  # indices of the open spans, innermost last
        self.counts = {}


class span:
    """``with span(name) as s:`` times the block; ``s.seconds`` after."""

    __slots__ = ("name", "parent", "t0", "t1", "_range", "_build")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        b = self._build = _local.build
        if b is not None:
            self.parent = b.stack[-1] if b.stack else None
            b.stack.append(len(b.spans))
            b.spans.append(self)
        if _profiling():
            import torch

            self._range = torch.profiler.record_function("pfbwt." + self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._build is not None:
            self._build.stack.pop()
        # the build keeps its spans: no reference back to it
        self._range = self._build = None
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@contextmanager
def build(info: dict):
    """The build of an entry point; ``info`` receives spans, counts and
    build_id when it is the outermost one."""
    if _local.build is not None:
        yield
        return
    b = _local.build = _Build()
    try:
        yield
    finally:
        _local.build = None
        info["spans"] = [(s.name, s.parent, s.t0, s.t1) for s in b.spans]
        info["counts"] = b.counts
        info["build_id"] = b.id


def count(name: str, n: int = 1):
    """Add ``n`` to the open build's counter ``name``."""
    b = _local.build
    if b is not None:
        b.counts[name] = b.counts.get(name, 0) + n


def host_read(t):
    """``t.cpu()``, counted: a read of device values is one sync
    (``syncs``) and its bytes (``d2h_bytes``)."""
    count("syncs")
    count("d2h_bytes", t.numel() * t.element_size())
    return t.cpu()


def _maybe_start_profile():
    """Start the process-wide profiler once, if PFBWT_PROFILE is set."""
    global _profiler
    prof_dir = os.environ.get("PFBWT_PROFILE", "")
    if not prof_dir or _profiler is not None:
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _profiler = prof

    def _export():
        prof.stop()
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(prof_dir, f"pfbwt_{os.getpid()}.json"))

    atexit.register(_export)


@contextmanager
def task_timer(label: str, name: str = None, file=None):
    """A TASK line for the block; yields its span where ``name`` is given,
    else None."""
    out = file if file is not None else sys.stderr
    _maybe_start_profile()
    if _profiling():
        import torch

        rng = torch.profiler.record_function(label)
    else:
        rng = nullcontext()
    s = span(name) if name else None
    t0 = time.perf_counter()
    try:
        with rng, (s if s is not None else nullcontext()):
            yield s
    finally:
        dur = s.seconds if s is not None else time.perf_counter() - t0
        print(f"TASK\t{label}\t{dur:.2f}s", file=out)
