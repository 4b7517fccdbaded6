"""Per-stage wall-clock lines on stderr: ``TASK\\t<name>\\t<sec>``, the
same text contract as the reference's RAII Timer (pfbwt-f.cpp:35-50).

With ``PFBWT_PROFILE=<dir>`` one ``torch.profiler`` run covers the
process (CPU, and CUDA where a card is present), each timed stage is a
``record_function`` range of its name, and the Chrome trace is exported
to ``<dir>/pfbwt_<pid>.json`` at exit.  Without the variable nothing but
the TASK lines happens.
"""

import atexit
import os
import sys
import time
from contextlib import contextmanager, nullcontext

_profiler = None  # the process-wide profiler, once PFBWT_PROFILE starts it


def _maybe_start_profile() -> bool:
    """Start the process-wide profiler once, if PFBWT_PROFILE is set."""
    global _profiler
    prof_dir = os.environ.get("PFBWT_PROFILE", "")
    if not prof_dir:
        return False
    if _profiler is not None:
        return True
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
    return True


@contextmanager
def task_timer(name: str, file=None):
    out = file if file is not None else sys.stderr
    if _maybe_start_profile():
        import torch

        span = torch.profiler.record_function(name)
    else:
        span = nullcontext()
    start = time.perf_counter()
    try:
        with span:
            yield
    finally:
        dur = time.perf_counter() - start
        print(f"TASK\t{name}\t{dur:.2f}s", file=out)
