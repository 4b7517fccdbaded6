"""SA -> marker-array permute on a device (pfbwtf_tpu/markers/ma_jax.py).

write_marker_array (marker_array.hpp:138-174) feeds every SA value through
rle_window_arr::at, a rank/select query per element.  Here it is one
``torch.searchsorted`` over the run starts, an elementwise run-membership
test and an adjacent compare of content ids; only the rows at the
coalesced run boundaries leave the device.  Eager torch runs each shape as
it comes, so the JAX package's padded query stream and its two-pass
count-then-compact are not needed; the runs are the same.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timer import host_read
from .rle_window import RleWindowArray


def marker_array_from_sa_dev(sa, mai: RleWindowArray, device="cuda"):
    """ma.marker_array_from_sa on ``device``: the same (starts, ends,
    markers) runs over SA-index space.  ``sa`` is a host array of SA
    values (uint64 or int64, each < 2**63) or a tensor, moved to
    ``device``; on the CPU the same torch ops run there."""
    dev = resolve_device(device)
    if isinstance(sa, torch.Tensor):
        sa = sa.to(dev, torch.int64)
    else:
        sa = np.ascontiguousarray(sa)
        if sa.dtype == np.uint64:
            sa = sa.view(np.int64)
        sa = torch.from_numpy(np.require(sa, np.int64, ("C", "W"))).to(dev)
    n = sa.shape[0]
    if n == 0 or not mai.starts.size:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64), []
    starts = torch.from_numpy(mai.starts).to(dev)
    ends = torch.from_numpy(mai.ends).to(dev)
    content = torch.from_numpy(mai.content_ids()).to(dev)
    idx = torch.searchsorted(starts, sa, right=True) - 1
    safe = torch.clamp(idx, 0, starts.shape[0] - 1)
    cid = torch.where((idx >= 0) & (sa <= ends[safe]), content[safe], -1)
    del safe
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    torch.ne(cid[1:], cid[:-1], out=boundary[1:])
    pos = torch.nonzero(boundary).flatten()
    rows = host_read(torch.stack((pos, cid[pos], idx[pos]))).numpy()
    pos, cid, ridx = rows
    run_ends = np.concatenate((pos[1:] - 1, [n - 1]))
    sel = cid >= 0
    markers = [np.asarray(mai.markers[int(r)], dtype=np.uint64)
               for r in ridx[sel]]
    return pos[sel].astype(np.uint64), run_ends[sel].astype(np.uint64), markers
