"""vcf_scan CLI of the port (src/vcf_scan.cpp:34-112 flag surface): emits
one haplotype FASTA (file or stdout) per sample+haplotype from a ref FASTA
+ VCF, plus a .mps marker-positions stream with -m.  Host only."""

import argparse
import sys

from ..io.fasta import write_fai
from ..vcf.reader import merge_vcfs
from ..vcf.scan import scan_vcf_sample, write_scan_outputs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vcf_scan")
    ap.add_argument("vcfs", nargs="+")
    ap.add_argument("-f", "--fasta", required=True, dest="ref_fasta")
    ap.add_argument("-w", "--window-size", type=int, default=10, dest="w")
    ap.add_argument("-x", "--marker-window-size", type=int, default=1,
                    dest="ma_w")
    ap.add_argument("-o", "--output", default="out")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-c", "--contigs", default="")
    ap.add_argument("-S", "--samples", default="")
    ap.add_argument("-H", "--haplotype", type=int, default=0)
    ap.add_argument("-r", "--ref-only", action="store_true")
    ap.add_argument("--stdout", action="store_true", dest="to_stdout")
    ap.add_argument("-m", "--marker-index", action="store_true", dest="mai")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    write_fai(args.ref_fasta)
    contigs = [c for c in args.contigs.split(",") if c] or None
    # index-seek per contig when a .csi/.tbi exists next to a bgzip'd VCF
    vcf = merge_vcfs(args.vcfs, contigs=contigs)
    samples = [s for s in args.samples.split(",") if s]
    targets = [""] if args.ref_only else samples

    for sample in targets:
        res = scan_vcf_sample(
            vcf,
            args.ref_fasta,
            sample,
            args.haplotype,
            w=args.w,
            ma_wsize=args.ma_w,
            ref_only=args.ref_only,
            want_markers=args.mai,
            contigs=contigs,
        )
        if args.ref_only:
            prefix = args.output + ".ref"
        else:
            prefix = f"{args.output}.{sample}.{args.haplotype}"
        if args.to_stdout:
            for name, seq in res.records:
                sys.stdout.write(f">{name}\n")
                sys.stdout.write(seq.tobytes().decode("ascii") + "\n")
            if args.mai:
                with open(prefix + ".mps", "wb") as f:
                    f.write(res.mps_bytes)
        else:
            write_scan_outputs(res, prefix, args.w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
