"""BWT of the parse: bwlast / ilist / bwsai (PfParser::bwt_of_parse,
pfparser.hpp:380-467).

* The SA of parse_ranks + [0] terminator (the sacak_int call, :425) comes
  from the doubling in ops/suffix.py.
* The SA -> bwlast/bwsai permutation (:431-451) is two gathers with the
  reference's wrap conventions: SA[0]=n -> last[n-2]/sai[n-1]; SA[i]==0 ->
  (0, 0); SA[i]==1 -> last wraps to last[n-1].
* The F-array counting sort into ilist (:452-462) is a stable argsort of
  the parse-BWT symbols.

``parse_bwt_core`` is the device body shared with the fused build;
``bwt_of_parse_device`` is the staged build's stage 2 (the ``.bwlast``,
``.ilist`` and ``.bwsai`` files).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.errors import die
from .suffix import _doubling

_BIG = (2**63 - 1) // 2


def parse_bwt_core(ranks_p, last_p, sai_p, n: int):
    """``ranks_p`` is padded to a bucket grid (true length n); a strictly
    descending sentinel tail goes AFTER the terminator, so every padded
    suffix sorts after every real one and the true SA fills the first n+1
    slots.  Returns (bwlast, ilist, bwsai, sym), each of length m+1."""
    m = ranks_p.shape[0]
    idx = torch.arange(m + 1, device=ranks_p.device)
    seq = torch.where(
        idx < n,
        ranks_p[torch.clamp(idx, 0, m - 1)],
        torch.where(idx == n, 0, _BIG - idx),
    )
    SA, _ = _doubling(seq)
    zero = SA == 0
    # floor modulo, as jnp's %: SA - 2 is negative where SA < 2
    prev2 = torch.clamp((SA - 2) % n, 0, m - 1)
    prev1 = torch.clamp((SA - 1) % n, 0, m - 1)
    bwlast = torch.where(zero, 0, last_p[prev2]).to(torch.uint8)
    bwsai = torch.where(zero, 0, sai_p[prev1])
    sym = torch.where(zero, 0, ranks_p[prev1])
    sym[0] = ranks_p[min(max(n - 1, 0), m - 1)]
    # padded rows must sort last: m+1 exceeds every rank (ranks <= n <= m)
    sym = torch.where(idx <= n, sym, m + 1 if m < 2**31 - 4 else _BIG)
    ilist = torch.argsort(sym, stable=True)
    return bwlast, ilist, bwsai, sym


@dataclass
class ParseBWT:
    bwlast: np.ndarray  # uint8, n+1
    ilist: np.ndarray  # int64 positions, n+1
    bwsai: np.ndarray  # uint64, n+1 (empty when get_sai is off)
    bwt_sym: np.ndarray  # parse-BWT symbols (phrase ranks, 0 = EOS), n+1


def bwt_of_parse_device(parse_ranks: np.ndarray, last: np.ndarray,
                        sai: np.ndarray, get_sai: bool = True,
                        device="cuda") -> ParseBWT:
    """The parse-BWT of the staged build on ``device``.  The JAX package
    pads the parse to a power-of-two bucket for its compile cache; the
    core's outputs at positions <= n do not depend on the padding, so the
    parse goes in at its own length."""
    dev = resolve_device(device)
    parse_ranks = np.asarray(parse_ranks, dtype=np.int64)
    n = parse_ranks.shape[0]
    if n == 1:
        die("error: only one dict word total. Re-run with a smaller p modulus")
    sai = np.asarray(sai, dtype=np.uint64)
    if sai.shape[0] == 0:
        sai = np.zeros(n, dtype=np.uint64)
    bwlast, ilist, bwsai, sym = parse_bwt_core(
        torch.from_numpy(parse_ranks).to(dev),
        torch.from_numpy(np.asarray(last, dtype=np.uint8)).to(dev),
        torch.from_numpy(sai.view(np.int64)).to(dev),
        n,
    )
    return ParseBWT(
        bwlast=bwlast.cpu().numpy(),
        ilist=ilist.cpu().numpy(),
        bwsai=(bwsai.cpu().numpy().view(np.uint64) if get_sai
               else np.zeros(0, dtype=np.uint64)),
        bwt_sym=sym.cpu().numpy(),
    )
