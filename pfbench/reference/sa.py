"""Suffix array, BWT and run-length SA samples by plain prefix doubling.

``suffix_array`` sorts the suffixes of a byte text plus a terminator by
their first 1, 2, 4, ... characters (one ``torch.sort`` of a packed
(rank, next rank) key a round) until every rank is distinct. On the card
a round over 138-268 M suffixes takes well under a second, so the whole
sort takes seconds where NumPy on the host would take minutes.
"""

import numpy as np
import torch


def suffix_array(text: np.ndarray, device, max_rounds: int = None):
    """(SA as an int64 tensor of n + 1 entries on ``device``, rounds).

    sa[0] = n, the terminator, which sorts below every byte. With
    ``max_rounds`` the doubling stops after that many rounds, whatever is
    left unresolved, and suffixes that still tie keep their text order:
    the suffix order is then exact only to the first 2**max_rounds
    characters (the control's broken guarantee)."""
    n = int(text.shape[0])
    size = n + 1
    rank = torch.zeros(size, dtype=torch.int64, device=device)
    rank[:n] = torch.from_numpy(np.require(text, np.uint8, "CW")).to(
        device, torch.int64) + 1
    scale = size + 1  # above every rank + 1
    h, rounds = 1, 0
    while True:
        nxt = torch.zeros(size, dtype=torch.int64, device=device)
        if h < size:
            nxt[:size - h] = rank[h:] + 1
        key = rank * scale + nxt
        del nxt
        key, sa = torch.sort(key, stable=max_rounds is not None)
        new = torch.zeros(size, dtype=torch.int64, device=device)
        new[1:] = torch.cumsum(key[1:] != key[:-1], 0)
        del key
        rank[sa] = new
        rounds += 1
        done = int(new[-1]) == size - 1
        del new
        if done or (max_rounds is not None and rounds >= max_rounds):
            return sa, rounds
        h *= 2


def bwt_of(text_t: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """bwt[i]: the byte before suffix sa[i]; byte 0 for suffix 0."""
    if text_t.shape[0] == 0:
        return torch.zeros(sa.shape[0], dtype=torch.uint8, device=sa.device)
    prev = torch.clamp(sa - 1, min=0)
    return torch.where(sa > 0, text_t[prev], torch.zeros_like(text_t[:1]))


def run_samples(bwt: torch.Tensor, sa: torch.Tensor):
    """(.ssa, .esa) as int64 tensors: (row, SA value) pairs, interleaved,
    at the first and the last row of every run of equal BWT bytes."""
    start = torch.ones(bwt.shape[0], dtype=torch.bool, device=bwt.device)
    start[1:] = bwt[1:] != bwt[:-1]
    rs = torch.nonzero(start).flatten()
    re = torch.cat((rs[1:] - 1, rs.new_tensor([bwt.shape[0] - 1])))
    return (torch.stack((rs, sa[rs]), 1).flatten(),
            torch.stack((re, sa[re]), 1).flatten())
