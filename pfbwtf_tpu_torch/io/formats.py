"""Readers and writers of the staged build's files, byte for byte those
of the reference (SURVEY.md §5.1).  All integer files are raw
little-endian arrays with no headers:

=========  ====================================================================
ext        contents (producer anchor in the reference)
=========  ====================================================================
.dict      sorted phrases, each + EndOfWord(0x01), file + EndOfDict(0x00)
           (pfbwt_io.hpp:71-82)
.occ       per-phrase occurrence counts, dict order, UIntType
           (pfparser.hpp:471-480)
.parse     phrase ranks, 1-based, uint32 ("int_text", gsacak.h:64) in text
           order (pfbwt_io.hpp:241)
.n         ASCII decimal text length + "\\n" (pfbwt-f.cpp:241-243)
.bwlast    char array, parse-BWT-permuted phrase "last" chars
           (pfparser.hpp:432-451)
.ilist     inverted lists, UIntType (pfparser.hpp:458-462)
.bwsai     parse-BWT-permuted phrase end positions, UIntType
.docs      text lines "name start" (pfbwt_io.hpp:224-231)
.bwt       n+1 bytes, 0x00 = EOS (pfbwt-f.cpp:299)
.sa        n+1 UIntType, first entry = n (pfbwt-f.cpp:300-303)
.ssa/.esa  (bwt-pos, SA-sample) pairs at run starts / ends
=========  ====================================================================

``UIntType`` is uint32 in the 32-bit build (pfbwt-f, CLI flag ``--u32``)
and uint64 in the 64-bit build (pfbwt-f64, the default); callers pass
``dtype``.
"""

import os
from typing import List, Sequence, Tuple

import numpy as np

U32 = np.dtype("<u4")
U64 = np.dtype("<u8")


def _tofile(path: str, arr: np.ndarray):
    with open(path, "wb") as f:
        f.write(arr.tobytes())


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def read_dict_flat(path: str) -> np.ndarray:
    """The raw .dict byte array (separators included) as uint8."""
    return np.frombuffer(_read(path), dtype=np.uint8)


def write_uint(path: str, arr, dtype=U64):
    _tofile(path, np.asarray(arr).astype(dtype, copy=False))


def read_uint(path: str, dtype=U64) -> np.ndarray:
    return np.frombuffer(_read(path), dtype=dtype)


def write_u8(path: str, arr):
    _tofile(path, np.asarray(arr).astype(np.uint8, copy=False))


def read_u8(path: str) -> np.ndarray:
    return np.frombuffer(_read(path), dtype=np.uint8)


def write_occ(path: str, occs, dtype=U64):
    write_uint(path, occs, dtype)


def read_occ(path: str, dtype=U64) -> np.ndarray:
    return read_uint(path, dtype)


def write_parse_ranks(path: str, ranks):
    # int_text is uint32 in BOTH the 32- and the 64-bit build (gsacak.h:64)
    write_uint(path, ranks, U32)


def read_parse_ranks(path: str) -> np.ndarray:
    return read_uint(path, U32)


def write_n(path: str, n: int):
    with open(path, "w") as f:
        f.write(f"{n}\n")


def read_n(path: str) -> int:
    with open(path) as f:
        return int(f.readline().strip())


def write_docs(path: str, names: Sequence[str], starts: Sequence[int]):
    with open(path, "w") as f:
        for name, start in zip(names, starts):
            f.write(f"{name} {start}\n")


def read_docs(path: str) -> Tuple[List[str], List[int]]:
    names, starts = [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            name, start = line.rsplit(None, 1)
            names.append(name)
            starts.append(int(start))
    return names, starts


def parse_files_exist(prefix: str) -> bool:
    """Checkpoint-existence probe (pfbwt_io.hpp:258-263)."""
    return (os.path.exists(prefix + ".dict")
            and os.path.exists(prefix + ".parse"))
