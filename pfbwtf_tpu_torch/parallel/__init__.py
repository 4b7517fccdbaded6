"""pfbwtf_tpu/parallel/ on one card and on torch.distributed: the pod
parse driver (driver: ``pfbwt_f --shards N``), the parse merge (merge),
and the mesh family, one rank per device (sharded, dsort, dict_union,
pfbwt_mesh, fused_mesh, multihost: ``--mesh``).  Importing it makes no
process group; a mesh call does (sharded.make_parse_mesh)."""

from .dict_union import distributed_parse_records, distributed_rank_rows
from .driver import pod_parse, split_fasta
from .dsort import distributed_doubling, dsort_blocks
from .fused_mesh import pfbwt_fused_mesh_records
from .merge import (
    load_or_generate_text,
    merge_parse_prefixes,
    reconstruct_text,
)
from .multihost import init_distributed, multihost_parse, \
    multihost_union_parse
from .pfbwt_mesh import mesh_assemble_bwt, mesh_parse_bwt
from .sharded import ParseMesh, make_parse_mesh, sharded_cut_mask

__all__ = [
    "reconstruct_text",
    "merge_parse_prefixes",
    "load_or_generate_text",
    "split_fasta",
    "pod_parse",
    "ParseMesh",
    "make_parse_mesh",
    "sharded_cut_mask",
    "dsort_blocks",
    "distributed_doubling",
    "distributed_rank_rows",
    "distributed_parse_records",
    "mesh_parse_bwt",
    "mesh_assemble_bwt",
    "pfbwt_fused_mesh_records",
    "init_distributed",
    "multihost_parse",
    "multihost_union_parse",
]
