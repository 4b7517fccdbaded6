"""dump_markers CLI (src/dump_markers.cpp): pretty-print .mps/.ma runs."""

import sys

from ..markers.dump import dump_markers_lines


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: dump_markers <.mps/.ma file>", file=sys.stderr)
        return 1
    for line in dump_markers_lines(argv[0]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
