"""readable_markers (scripts/readable_markers.py role): dump a .ma run file
as per-position text lines."""

import sys

from ..markers.dump import readable_markers_lines


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: readable_markers <.ma file>", file=sys.stderr)
        return 1
    for line in readable_markers_lines(argv[0]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
