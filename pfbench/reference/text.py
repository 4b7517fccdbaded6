"""FASTA records and the text a build indexes.

The text of a collection is every record's sequence, upper-cased, each
followed by ``w`` 'A's (the prefix-free parse's per-record pad of
pfbwt-f's parser). Its suffix array has one more entry, the terminator at
position n, which sorts below every byte.
"""

import numpy as np


def read_fasta(path: str):
    """[(name, uint8 sequence)] of a FASTA file, line breaks removed."""
    with open(path, "rb") as f:
        data = f.read()
    records = []
    for block in data.split(b">")[1:]:
        head, _, body = block.partition(b"\n")
        seq = body.replace(b"\n", b"").replace(b"\r", b"")
        records.append((head.split()[0].decode() if head.split() else "",
                        np.frombuffer(seq.upper(), dtype=np.uint8)))
    return records


def collection_text(seqs, w: int) -> np.ndarray:
    """The sequences, each followed by ``w`` 'A's, as one uint8 array."""
    pad = np.full(w, ord("A"), dtype=np.uint8)
    parts = []
    for s in seqs:
        parts += [np.asarray(s, dtype=np.uint8), pad]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)
