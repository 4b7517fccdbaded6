"""The single-device parts of pfbwtf_tpu/parallel/: the dictionary dedup
on the device (dict_union), the parse merge (merge) and the pod parse
driver (driver: ``pfbwt_f --shards N``)."""

from .driver import pod_parse, split_fasta
from .merge import (
    load_or_generate_text,
    merge_parse_prefixes,
    reconstruct_text,
)

__all__ = [
    "reconstruct_text",
    "merge_parse_prefixes",
    "load_or_generate_text",
    "split_fasta",
    "pod_parse",
]
