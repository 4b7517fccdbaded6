"""dump_intfile CLI (scripts/dump_intfile.cpp:7-47): raw little-endian
integer file -> one decimal per line.  -b = 32-bit (default), -l = 64-bit;
reads the named file or stdin."""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dump_intfile")
    ap.add_argument("file", nargs="?", default="-")
    ap.add_argument("-b", action="store_true", help="32-bit ints (default)")
    ap.add_argument("-l", action="store_true", help="64-bit ints")
    args = ap.parse_args(argv)
    dtype = np.uint64 if args.l else np.uint32
    raw = (
        sys.stdin.buffer.read()
        if args.file == "-"
        else open(args.file, "rb").read()
    )
    vals = np.frombuffer(raw[: len(raw) - len(raw) % np.dtype(dtype).itemsize],
                         dtype=dtype)
    sys.stdout.write("\n".join(str(int(v)) for v in vals))
    if vals.size:
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
