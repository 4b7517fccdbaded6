"""glibc malloc tuning for large-array workloads.

Raises M_MMAP_THRESHOLD / M_TRIM_THRESHOLD so numpy's large temporaries are
served from the reused sbrk heap instead of fresh mmap regions, whose pages
fault in again on first touch for every temporary; heap reuse pays the
population cost once per high-water mark.

pfbwtf_tpu calls ``tune_malloc`` when it is imported.  The port's import
changes no global setting: its build CLIs (pfbwt_f, merge_pfp,
vcf_to_bwt) call it first thing, and so does each shard parse of the pod
parse (parallel/driver.py).  scripts/malloc_probe.py measured
the effect on the 64 MB staged build and the pod parse's shard parses.

No-op (harmless) where glibc is absent or mallopt fails.
"""

import ctypes

_M_MMAP_THRESHOLD = -3
_M_TRIM_THRESHOLD = -1


def tune_malloc(threshold_bytes: int = 1 << 30) -> bool:
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
    except OSError:
        return False
    return bool(ok1 and ok2)
