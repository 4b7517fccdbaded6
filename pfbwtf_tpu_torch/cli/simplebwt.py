"""simplebwt CLI (simplebwt.c:28-100): brute-force BWT oracle for small
inputs — plain suffix array over the whole text, no PFP.  Host only."""

import argparse
import sys

import numpy as np

from ..io.fasta import read_fasta_bytes
from ..ops.suffix_np import suffix_array_ints_np


def bwt_via_sa(text: np.ndarray):
    seq = np.concatenate((text.astype(np.int64) + 1, [0]))
    sa = suffix_array_ints_np(seq)
    bwt = np.where(sa == 0, np.uint8(0), text[(sa - 1) % text.shape[0]])
    return bwt.astype(np.uint8), sa


def main(argv=None):
    ap = argparse.ArgumentParser(prog="simplebwt")
    ap.add_argument("fasta")
    ap.add_argument("-o", "--output", default="")
    ap.add_argument("-s", "--sa", action="store_true")
    args = ap.parse_args(argv)
    records = read_fasta_bytes(args.fasta)
    text = np.concatenate([seq for _, seq in records])
    bwt, sa = bwt_via_sa(text)
    out = args.output or args.fasta
    with open(out + ".bwt", "wb") as f:
        f.write(bwt.tobytes())
    if args.sa:
        with open(out + ".sa", "wb") as f:
            f.write(sa.astype(np.uint64).tobytes())
    return 0


if __name__ == "__main__":
    sys.exit(main())
