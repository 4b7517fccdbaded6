"""Kernel K1, the cut scan (pfbwtf_tpu_torch/csrc/hash_scan.cu): one byte
of text read and one byte of cut mask written a position of the text the
build indexes. The padding to the build's bucket is not work."""

from . import HBM_BYTES_PER_S

KERNEL = "cut_scan_kernel"  # the kernel's name in the profiler trace


def bytes_moved(text_n: int) -> int:
    return 2 * int(text_n)


def least_seconds(text_n: int) -> float:
    """The least time the card could take: bytes over HBM bandwidth."""
    return bytes_moved(text_n) / HBM_BYTES_PER_S
