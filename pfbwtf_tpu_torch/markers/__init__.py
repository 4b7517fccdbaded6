from .marker import (
    create_marker,
    get_allele,
    get_pos,
    get_seq,
    set_allele,
    set_pos,
    set_seq,
    DELIM,
)
from .mps import MarkerPositionsWriter, read_mps_runs, write_mps_runs, merge_mps
from .rle_window import RleWindowArray
from .ma import write_marker_array, marker_array_from_sa

__all__ = [
    "create_marker",
    "get_allele",
    "get_pos",
    "get_seq",
    "set_allele",
    "set_pos",
    "set_seq",
    "DELIM",
    "MarkerPositionsWriter",
    "read_mps_runs",
    "write_mps_runs",
    "merge_mps",
    "RleWindowArray",
    "write_marker_array",
    "marker_array_from_sa",
]
