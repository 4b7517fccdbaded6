"""readable_sa (scripts/readable_sa.py role): dump a binary .sa as text."""

import sys

from ..markers.dump import readable_sa_lines


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: readable_sa <.sa file>", file=sys.stderr)
        return 1
    for line in readable_sa_lines(argv[0]):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
