"""The merge of per-haplotype parses (merge_pfp), worked out plainly.

merge_pfp folds saved parses into one (PfParser::operator+=,
pfparser.hpp:194-263). Each record of a parse ends with w pad 'A's, which
bring the window hash back to the state it has after w 'A's, so the
merged parse is the parse of the records one after another: its seven
checkpoint files are ``pfp.checkpoint_files`` of the collection text of
every shard's records in order. Only ``.docs`` is the merge's own: a line
``name start`` a record (pfbwt_io.hpp:224-231), ``start`` the record's
offset in that text (each record before it with its w pads), the names
in the order of the shards and their records.
"""

import numpy as np


def docs_file(records, w: int) -> np.ndarray:
    """The ``.docs`` bytes of ``records`` ([(name, sequence)]) merged in
    order, as uint8."""
    lines, off = [], 0
    for name, seq in records:
        lines.append(f"{name} {off}\n")
        off += int(len(seq)) + w
    return np.frombuffer(bytearray("".join(lines).encode()), dtype=np.uint8)
