"""consensus CLI (src/consensus.cpp role, pipeline-relevant subset).

The reference ships a fork of bcftools consensus extended with
-x/--markers + --marker_wsize to emit a .mps marker stream while applying
variants (consensus.cpp:683, :937).  Functionally this is vcf_scan's
haplotype materialization with bcftools-style flags, which is what this
wrapper provides: apply a sample's haplotype to the reference FASTA, write
the consensus FASTA, optionally write markers.

bcftools compatibility notes: -H is 1-based (1|2); with no sample the
reference alleles are applied (gt=0 everywhere).  Supported transforms:
-p prefix, --mark-del/--mark-ins/--mark-snv, -a absent, -M missing,
-m mask (BED) + --mask-with CHAR|uc|lc, -c chain output
(consensus.cpp:144-260), -i/-e site filter expressions over the
TYPE/QUAL/FILTER/POS/ID/REF/ALT core (consensus.cpp:288,397-401; full
htslib expression grammar is larger — unsupported constructs error out
loudly).  -I/--iupac-codes is DISABLED in the reference itself
(consensus.cpp:1120).
"""

import argparse
import sys

from ..io.fasta import write_fai
from ..vcf.reader import merge_vcfs
from ..vcf.scan import ConsensusOpts, read_mask_bed, scan_vcf_sample


def _mark_case(val: str, flag: str) -> str:
    if val not in ("uc", "lc"):
        raise SystemExit(f"The argument is not recognised: {flag} {val}")
    return val


def main(argv=None):
    ap = argparse.ArgumentParser(prog="consensus")
    ap.add_argument("vcfs", nargs="+")
    ap.add_argument("-f", "--fasta-ref", required=True, dest="ref")
    ap.add_argument("-s", "--sample", default="")
    ap.add_argument("-H", "--haplotype", type=int, default=1,
                    help="1-based haplotype (bcftools convention)")
    ap.add_argument("-o", "--output", default="-",
                    help="output fasta ('-' = stdout)")
    ap.add_argument("-x", "--markers", default="",
                    help="write marker positions (.mps) to this file")
    # reference flag map (consensus.cpp:1166-1167, 1245-1256): -w is the
    # MARKER window (ma_w), -l the inter-contig length bias (len_bias,
    # the w-pad added to marker text positions at each contig end)
    ap.add_argument("-w", "--marker_wsize", type=int, default=19,
                    dest="marker_wsize")  # reference default, consensus.cpp:1144
    ap.add_argument("-l", "--marker_length_bias", type=int, default=10,
                    dest="w")
    ap.add_argument("-p", "--prefix", default="",
                    help="prefix added to output sequence names")
    ap.add_argument("--mark-del", default="", metavar="CHAR",
                    help="insert CHAR for deleted bases instead of "
                         "removing them")
    ap.add_argument("--mark-ins", default="", metavar="uc|lc",
                    help="case of inserted bases")
    ap.add_argument("--mark-snv", default="", metavar="uc|lc",
                    help="case of substituted bases")
    ap.add_argument("-a", "--absent", default="", metavar="CHAR",
                    help="replace positions absent from the VCF with CHAR")
    ap.add_argument("-M", "--missing", default="", metavar="CHAR",
                    help="output CHAR for missing genotypes ./.")
    ap.add_argument("-m", "--mask", default="", metavar="FILE",
                    help="BED file of regions to mask")
    ap.add_argument("--mask-with", default="N", metavar="CHAR|uc|lc")
    ap.add_argument("-c", "--chain", default="", metavar="FILE",
                    help="write a UCSC liftover chain file for the "
                         "ref->consensus coordinate mapping")
    ap.add_argument("-i", "--include", default="", metavar="EXPR",
                    help="apply only sites for which the expression is "
                         "true (TYPE/QUAL/FILTER/POS/ID/REF/ALT core)")
    ap.add_argument("-e", "--exclude", default="", metavar="EXPR",
                    help="skip sites for which the expression is true")
    args = ap.parse_args(argv)

    for flag, val in (("--mark-ins", args.mark_ins),
                      ("--mark-snv", args.mark_snv)):
        if val:
            _mark_case(val, flag)
    if args.include and args.exclude:
        print("error: only one of -i or -e can be given", file=sys.stderr)
        return 1
    site_filter = None
    if args.include or args.exclude:
        from ..vcf.filter import compile_filter

        site_filter = compile_filter(args.include or args.exclude)
    copts = None
    if (args.prefix or args.mark_del or args.mark_ins or args.mark_snv
            or args.absent or args.missing or args.mask or args.chain
            or site_filter is not None):
        copts = ConsensusOpts(
            mark_del=args.mark_del,
            mark_ins=args.mark_ins,
            mark_snv=args.mark_snv,
            absent=args.absent,
            missing=args.missing,
            prefix=args.prefix,
            mask=read_mask_bed(args.mask) if args.mask else {},
            mask_with=args.mask_with,
            chain=bool(args.chain),
            site_filter=site_filter,
            filter_exclude=bool(args.exclude),
        )
        if args.markers and copts.length_changing():
            print("error: length-changing consensus options cannot be "
                  "combined with -x/--markers", file=sys.stderr)
            return 1

    write_fai(args.ref)
    # raw FORMAT retention only when the filter expression needs it
    # (FMT/TAG other than GT) — panel-scale memory is opt-in
    import re as _re

    need_fmt = bool(_re.search(
        r"\b(?:FMT|FORMAT)/(?!GT\b)", args.include + " " + args.exclude,
        _re.IGNORECASE,
    ))
    vcf = merge_vcfs(args.vcfs, store_format=need_fmt)
    res = scan_vcf_sample(
        vcf,
        args.ref,
        args.sample,
        max(args.haplotype - 1, 0),
        w=args.w,
        ma_wsize=args.marker_wsize,
        ref_only=(args.sample == ""),
        want_markers=bool(args.markers),
        copts=copts,
    )
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    for name, seq in res.records:
        out.write(f">{name}\n")
        out.write(seq.tobytes().decode("ascii") + "\n")
    if out is not sys.stdout:
        out.close()
    if args.markers:
        with open(args.markers, "wb") as f:
            f.write(res.mps_bytes)
    if args.chain:
        with open(args.chain, "w") as f:
            f.write(res.chain_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
