"""Nucleotide code tables (reference utils.c:139-180).

* ``NTOA_TABLE`` feeds the rolling hash: A/a->0, C/c->1, G/g->2, T/t->3,
  and, as in the reference, N/n->0 and '-'->3.  Everything else maps to 5,
  a fatal invalid character for the hasher.
* ``NT4_TABLE`` drives ``--non-acgt-to-a``: only A/C/G/T (either case)
  map to 0..3; everything else maps to 4 and is replaced by 'A'.

The tables gather on the host; ``upper_dev``, ``first_invalid`` and
``ntoa_codes`` apply the same rules to a device tensor as compares and
masked fills on uint8 and bool, with no index array of its length.
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


def die_invalid(byte: int):
    """Raise PfbwtError for ``byte``, a byte the hasher cannot take
    (pfparser.hpp:345-351)."""
    die(f"invalid character {byte}/{chr(byte)} in input "
        "(use --non-acgt-to-a)")


def codes_or_die(chars: np.ndarray) -> np.ndarray:
    """NTOA_TABLE[chars]; raises PfbwtError at the first byte the hasher
    cannot take (pfparser.hpp:345-351)."""
    codes = NTOA_TABLE[chars]
    if codes.max(initial=0) > 3:
        die_invalid(int(chars[codes > 3][0]))
    return codes


def upper_dev(chars_u8: torch.Tensor, non_acgt_to_a: bool):
    """In place: UPPER_TABLE (std::toupper over the byte range), then with
    ``non_acgt_to_a`` every byte but A/C/G/T to 'A' (NT4_TABLE's rule),
    as ops/parse.normalize_records does on the host."""
    # a..z: the byte less 'a' wraps in uint8, so one compare finds them
    lower = (chars_u8 - ord("a")) < 26
    chars_u8.sub_(lower.view(torch.uint8), alpha=32)
    del lower
    if non_acgt_to_a:
        acgt = chars_u8 == ord("A")
        for ch in b"CGT":
            acgt |= chars_u8 == ch
        chars_u8.masked_fill_(~acgt, ord("A"))


def first_invalid(chars_u8: torch.Tensor) -> torch.Tensor:
    """The check of codes_or_die with no read: an int64 pair on the
    device, 1 and the first byte that NTOA_TABLE maps to 5, or 0 and a
    valid byte where there is none.  A reduction finds the first one, as
    ``torch.max`` returns the first index of its maximum."""
    u = chars_u8 & 0xDF  # uppercase ASCII letters
    ok = chars_u8 == ord("-")
    for ch in b"ACGTN":
        ok |= u == ch
    del u
    flag, at = torch.max((~ok).view(torch.uint8), 0)
    return torch.cat((flag.view(1), chars_u8.index_select(0, at.view(1)))
                     ).to(torch.int64)


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
