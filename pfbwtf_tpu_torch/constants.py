"""Special symbols, parse defaults and size limits.

Byte-level contract of the reference (utils.h:8-31): these values appear
verbatim inside .dict files and as the BWT EOS byte, so they are fixed.
"""

# Special symbols used by the construction algorithm. They cannot appear in
# the input text; 0x00 is used in the final .bwt file as the EOS char.
Dollar = 2  # parsing sentinel; highest special char
EndOfWord = 1  # word delimiter inside the .dict file
EndOfDict = 0  # terminator of the .dict file


class EXT:
    """File-name extensions of the staged build's files (utils.h:17-31)."""

    PARSE = "parse"
    OCC = "occ"
    DICT = "dict"
    BWLST = "bwlast"
    BWSAI = "bwsai"
    ILIST = "ilist"
    SA = "sa"
    SSA = "ssa"
    ESA = "esa"
    BWT = "bwt"
    N = "n"
    DOCS = "docs"


# Default parsing parameters (pfparser.hpp:37-38).
DEFAULT_W = 10
DEFAULT_P = 100

# The rolling k-mer is 2-bit packed into a uint64 (pfparser.hpp:371-376).
MAX_W = 32

# Size limits: the 32-bit build caps the text at 2^32-1 chars
# (pfparser.hpp:326-331) and the parse at 2^31-2 phrases; both builds cap
# the parse at 2^32-2 phrases, since parse ranks are uint32 in both
# (pfparser.hpp:393-405, gsacak.h:64).
MAX_TEXT_32 = 0xFFFFFFFF
MAX_PHRASES_32 = 0x7FFFFFFE
MAX_PHRASES_64 = 0xFFFFFFFE
