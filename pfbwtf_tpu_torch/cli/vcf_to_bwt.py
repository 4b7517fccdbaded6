"""vcf_to_bwt CLI of the port: the flag surface of the reference
orchestrator (vcf_to_bwt.py:296-320), every heavy stage on the CUDA card.

    python -m pfbwtf_tpu_torch.cli.vcf_to_bwt [options] <fasta> <vcf>...

``--device`` is accepted and changes nothing (the parse, parse-BWT,
assembly and SA->MA permute run on the card already); ``--mmap/-M`` is
accepted and read by nothing, as in pfbwtf_tpu; ``--mesh`` runs the
fused build over the mesh (a one-rank world in one process; under
torchrun rank 0 scans and writes, and every rank returns the same exit
code).
"""

import argparse
import sys

from ..io import formats
from ..utils.errors import PfbwtError
from ..utils.malloc_tuning import tune_malloc
from ..vcf.pipeline import VcfToBwtConfig, vcf_to_bwt


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(prog="vcf_to_bwt")
    ap.add_argument("fasta", help="reference fasta file")
    ap.add_argument("vcf", nargs="+", help="vcf/bcf files with haplotype panel")
    ap.add_argument("--samples", "-S",
                    help="file of newline-delimited samples (default: all)")
    ap.add_argument("--threads", "-t", type=int, default=1)
    ap.add_argument("--save_fasta", "-f", action="store_true")
    ap.add_argument("-o", default="out")
    ap.add_argument("--no_merge", action="store_true",
                    help="accepted for compatibility (merge is implicit)")
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("--ma", "-m", action="store_true",
                    help="build marker array")
    ap.add_argument("--keep_parse", action="store_true")
    ap.add_argument("-s", "--sa", action="store_true")
    ap.add_argument("-r", "--rssa", action="store_true")
    ap.add_argument("--mmap", "-M", action="store_true")
    ap.add_argument("--ma_wsize", default=1, type=int)
    ap.add_argument("--wsize", default=10, type=int)
    ap.add_argument("--mod", default=10, type=int)
    ap.add_argument("--contigs", default="",
                    help="comma-separated contig subset (uses the VCF's "
                         ".csi/.tbi index to seek when present)")
    ap.add_argument("--u32", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="every heavy stage on the card (always the case "
                         "here)")
    ap.add_argument("--fused", action="store_true",
                    help="whole-pipeline device run for the parse->BWT->SA "
                         "stages (no checkpoint files)")
    ap.add_argument("--mesh", action="store_true",
                    help="fused mesh pipeline: the mesh parse and the "
                         "distributed emission sort")
    args = ap.parse_args(argv)
    tune_malloc()  # numpy temporaries reuse the heap (malloc_tuning.py)

    samples = None
    if args.samples:
        with open(args.samples) as f:
            samples = [s for s in f.read().strip().split("\n") if s]
    cfg = VcfToBwtConfig(
        fasta=args.fasta,
        vcfs=args.vcf,
        output=args.o,
        samples=samples,
        wsize=args.wsize,
        mod=args.mod,
        ma_wsize=args.ma_wsize,
        sa=args.sa,
        rssa=args.rssa,
        ma=args.ma,
        save_fasta=args.save_fasta,
        keep_parse=args.keep_parse or not args.clean,
        threads=args.threads,
        dtype=formats.U32 if args.u32 else formats.U64,
        device=device,
        contigs=[c for c in args.contigs.split(",") if c] or None,
        fused=args.fused,
        mesh=args.mesh,
    )
    try:
        vcf_to_bwt(cfg)
    except PfbwtError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
