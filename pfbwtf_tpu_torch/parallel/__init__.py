"""The single-device parts of pfbwtf_tpu/parallel/: the dictionary dedup
on the device (dict_union) and the parse merge (merge)."""

from .merge import (
    load_or_generate_text,
    merge_parse_prefixes,
    reconstruct_text,
)

__all__ = [
    "reconstruct_text",
    "merge_parse_prefixes",
    "load_or_generate_text",
]
