"""mps_to_ma CLI of the port (src/mps_to_ma.cpp:43-51): SA stream + .mps
-> .ma, the permute on the CUDA card (``--device`` is accepted and changes
nothing)."""

import argparse
import sys

from ..markers.ma import write_marker_array


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(prog="mps_to_ma")
    ap.add_argument("mps")
    ap.add_argument("sa", help=".sa file of uint64 values, or '-' for stdin")
    ap.add_argument("-o", "--output", default="out")
    ap.add_argument("-m", "--mmap", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--device", action="store_true",
                    help="the SA->MA permute on the card (always the case "
                         "here)")
    args = ap.parse_args(argv)
    write_marker_array(args.mps, args.sa, args.output, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
