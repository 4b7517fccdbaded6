"""Nucleotide code tables (reference utils.c:139-180).

* ``NTOA_TABLE`` feeds the rolling hash: A/a->0, C/c->1, G/g->2, T/t->3,
  and, as in the reference, N/n->0 and '-'->3.  Everything else maps to 5,
  a fatal invalid character for the hasher.
* ``NT4_TABLE`` drives ``--non-acgt-to-a``: only A/C/G/T (either case)
  map to 0..3; everything else maps to 4 and is replaced by 'A'.
"""

import numpy as np
import torch

from .errors import die


def _build_ntoa() -> np.ndarray:
    t = np.full(256, 5, dtype=np.uint8)
    for chars, v in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
        for ch in chars:
            t[ord(ch)] = v
    t[ord("N")] = 0
    t[ord("n")] = 0
    t[ord("-")] = 3
    return t


def _build_nt4() -> np.ndarray:
    t = np.full(256, 4, dtype=np.uint8)
    for chars, v in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
        for ch in chars:
            t[ord(ch)] = v
    return t


NTOA_TABLE = _build_ntoa()
NT4_TABLE = _build_nt4()

# Uppercasing table (std::toupper over the byte range, pfparser.hpp:337).
UPPER_TABLE = np.arange(256, dtype=np.uint8)
UPPER_TABLE[ord("a"): ord("z") + 1] -= 32


def codes_or_die(chars: np.ndarray) -> np.ndarray:
    """NTOA_TABLE[chars]; raises PfbwtError at the first byte the hasher
    cannot take (pfparser.hpp:345-351)."""
    codes = NTOA_TABLE[chars]
    if codes.max(initial=0) > 3:
        bad = chars[codes > 3][0]
        die(f"invalid character {bad}/{chr(bad)} in input "
            "(use --non-acgt-to-a)")
    return codes


def ntoa_codes(chars_u8: torch.Tensor) -> torch.Tensor:
    """NTOA_TABLE as compares and selects, for chars already validated by
    the caller (no byte that the table maps to 5): A/a/N/n->0, C/c->1,
    G/g->2, T/t/'-'->3.  Masked fills: an assignment through a bool mask
    would build the int64 indices of its lanes (and wait for the card)."""
    u = chars_u8 & 0xDF  # uppercase ASCII letters
    codes = torch.zeros_like(chars_u8)
    codes.masked_fill_(u == ord("C"), 1)
    codes.masked_fill_(u == ord("G"), 2)
    codes.masked_fill_((u == ord("T")) | (chars_u8 == ord("-")), 3)
    return codes
