"""Subprocess entry point for one haplotype scan.

The orchestrator's data parallelism is the reference's process-per-scan
design (vcf_to_bwt.py:230-237, pipe wiring :128-136) re-expressed as
explicit ``python -m pfbwtf_tpu_torch.vcf.scan_worker`` children over a
file protocol: the parent pickles the parsed columnar VCF, the scan
settings (a dict of plain values) and the task list once, each worker
scans one (sample, haplotype) and pickles its ScanResult back.  This
avoids fork() from a parent whose CUDA context and threads a child must
not inherit, and multiprocessing spawn/forkserver's __main__ re-execution,
which breaks guard-less scripts and programs read from stdin.  A
worker is host-only: it imports numpy and the VCF modules, never torch.
"""

import pickle
import sys


def scan_task(vcf, scan_args: dict, task):
    """One haplotype scan: ``task`` is (sample, hap, ref_only);
    ``scan_args`` holds fasta, w, ma_wsize and want_markers."""
    from .scan import scan_vcf_sample

    sample, hap, ref_only = task
    return scan_vcf_sample(
        vcf, scan_args["fasta"], sample, hap, w=scan_args["w"],
        ma_wsize=scan_args["ma_wsize"], ref_only=ref_only,
        want_markers=scan_args["want_markers"],
    )


def main(ctx_path: str, idx: str, out_path: str) -> None:
    with open(ctx_path, "rb") as f:
        vcf, scan_args, tasks = pickle.load(f)
    res = scan_task(vcf, scan_args, tasks[int(idx)])
    with open(out_path, "wb") as f:
        pickle.dump(res, f, protocol=pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main(*sys.argv[1:4])
