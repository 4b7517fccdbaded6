"""Differences between what a build produced and what the reference
worked out: a count of entries that differ, plus the difference in
length. Every such number is held to 0."""

import numpy as np
import torch


def as_tensor(a, device) -> torch.Tensor:
    """A host array (uint64 read as int64) or a tensor, on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(device)


def differences(got, want: torch.Tensor) -> int:
    g = as_tensor(got, want.device).to(want.dtype)
    m = min(g.shape[0], want.shape[0])
    return abs(g.shape[0] - want.shape[0]) + int((g[:m] != want[:m]).sum())


def text_differences(bwt, sa,
                     text: torch.Tensor) -> int:
    """Positions of the text that the BWT and the SA of a build spell out
    wrong: text[sa[i] - 1] = bwt[i] for every row with sa[i] > 0. A
    position no row spells counts as wrong."""
    n = text.shape[0]
    b = as_tensor(bwt, text.device)
    s = as_tensor(sa, text.device)
    if b.shape[0] != n + 1 or s.shape[0] != n + 1:
        return n + abs(b.shape[0] - n - 1) + abs(s.shape[0] - n - 1)
    spelled = torch.full((n + 1,), 256, dtype=torch.int16,
                         device=text.device)
    ok = (s > 0) & (s <= n)
    spelled[torch.where(ok, s - 1, n)] = torch.where(
        ok, b.to(torch.int16), spelled.new_tensor(256))
    return int((spelled[:n] != text.to(torch.int16)).sum())
