"""merge_mps CLI of the port (src/merge_mps.cpp:14-25): usage
``merge_mps <output> <prefix 1> ... <prefix n>``."""

import sys

from ..markers.mps import merge_mps


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(
            "usage: merge_mps <output> <prefix 1> ... <prefix n>",
            file=sys.stderr,
        )
        return 1
    merge_mps(argv[0], argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
