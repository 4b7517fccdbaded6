"""Size-limit guards with the reference's die() semantics: text length in
the 32-bit build (pfparser.hpp:326-331) and phrase count in both builds
(pfparser.hpp:393-405)."""

import sys

import numpy as np

from .. import constants
from .errors import die


def _is_u32(dtype) -> bool:
    return np.dtype(dtype).itemsize <= 4


def check_text_width(total_l: int, dtype):
    """32-bit builds cap the text at 2^32-1 chars (pfparser.hpp:326-331)."""
    if _is_u32(dtype) and total_l > constants.MAX_TEXT_32:
        print(f"size: {total_l}", file=sys.stderr)
        die("input too long, please use 64-bit version")


def check_phrase_count(nphrases: int, dtype=None):
    """Phrase-count caps (pfparser.hpp:393-405): 2^32-2 always (ranks are
    uint32 everywhere), 2^31-2 as well when writing 32-bit outputs."""
    if dtype is not None and _is_u32(dtype) and (
        nphrases > constants.MAX_PHRASES_32
    ):
        print(f"parse ranks size: {nphrases}", file=sys.stderr)
        die(
            "Input containing more than 2^31-2 phrases! "
            "Please use 64 bit version"
        )
    if nphrases > constants.MAX_PHRASES_64:
        print(f"parse ranks size: {nphrases}", file=sys.stderr)
        die(
            "Input containing more than 2^32-2 phrases! "
            "This is currently a hard limit"
        )
