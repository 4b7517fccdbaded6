"""BWT of the parse: bwlast / ilist / bwsai (PfParser::bwt_of_parse,
pfparser.hpp:380-467).

* The SA of parse_ranks + [0] terminator (the sacak_int call, :425) comes
  from the doubling in ops/suffix.py on the device, and from the native
  SA-IS kernel (else the numpy doubling) on the host.
* The SA -> bwlast/bwsai permutation (:431-451) is two gathers with the
  reference's wrap conventions: SA[0]=n -> last[n-2]/sai[n-1]; SA[i]==0 ->
  (0, 0); SA[i]==1 -> last wraps to last[n-1].
* The F-array counting sort into ilist (:452-462) is a stable argsort of
  the parse-BWT symbols.

``parse_bwt_core`` is the device body shared with the fused build;
``bwt_of_parse_device`` is the staged build's stage 2 (the ``.bwlast``,
``.ilist`` and ``.bwsai`` files) on a device, and ``bwt_of_parse`` the
same stage on the host (engine.parse_bwt with the ``numpy`` backend).
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..utils.device import resolve_device
from ..utils.errors import die
from ..utils.timer import host_read
from .suffix import _doubling
from .suffix_np import suffix_array_ints_np

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
        bwlast=host_read(bwlast).numpy(),
        ilist=host_read(ilist).numpy(),
        bwsai=(host_read(bwsai).numpy().view(np.uint64) if get_sai
               else np.zeros(0, dtype=np.uint64)),
        bwt_sym=host_read(sym).numpy(),
    )


def _parse_sa_host(seq):
    """SA of the parse-rank sequence: native SA-IS when available, else
    numpy doubling."""
    if native.available():
        return native.suffix_array_ints_native(seq)
    return suffix_array_ints_np(seq)


def bwt_of_parse(parse_ranks: np.ndarray, last: np.ndarray, sai: np.ndarray,
                 get_sai: bool = True, sa_fn=None) -> ParseBWT:
    """The parse-BWT on the host (pfbwtf_tpu/ops/parse_bwt.py::
    bwt_of_parse): the parse SA, the wrap-gather permutes, and the stable
    argsort of the parse-BWT symbols that gives the ilist."""
    if sa_fn is None:
        sa_fn = _parse_sa_host
    parse_ranks = np.asarray(parse_ranks, dtype=np.int64)
    n = parse_ranks.shape[0]
    if n == 1:
        die("error: only one dict word total. Re-run with a smaller p modulus")
    seq = np.concatenate((parse_ranks, np.zeros(1, dtype=np.int64)))
    SA = np.asarray(sa_fn(seq), dtype=np.int64)  # length n+1, SA[0] == n
    assert SA[0] == n, "parse SA must start with the terminator suffix"

    last = np.asarray(last)
    sai = np.asarray(sai, dtype=np.uint64)
    zero = SA == 0
    # bwlast: preceding-phrase "last" char with the reference's wrap quirks
    bwlast = np.where(zero, np.uint8(0), last[(SA - 2) % n])
    if get_sai:
        bwsai = np.where(zero, np.uint64(0), sai[(SA - 1) % n])
    else:
        bwsai = np.zeros(0, dtype=np.uint64)
    # parse-BWT symbols: phrase rank preceding each suffix (0 for EOS)
    bwt_sym = np.where(zero, 0, parse_ranks[(SA - 1) % n])
    bwt_sym[0] = parse_ranks[n - 1]
    # ilist = stable counting sort by symbol (== ilist[F[sym]++] = i)
    ilist = np.argsort(bwt_sym, kind="stable").astype(np.int64)
    return ParseBWT(bwlast=bwlast.astype(np.uint8), ilist=ilist, bwsai=bwsai,
                    bwt_sym=bwt_sym)
