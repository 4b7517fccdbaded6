#!/usr/bin/env python3
"""Where the time of the host assembly (stage 3 with the numpy backend)
goes, beside the card's assembly of the same arrays.

    python scripts/profile_host_assembly.py [--size-mb 64]

Builds chip_smoke.py's pan-genome input (seed 4321, w=10, p=100, 8
copies), runs stages 1 and 2 on the card, then stage 3 with -s -r's
outputs: on the card (ops/bwt_dev.assemble_bwt_dev, after a warm-up run)
and on the host (ops/bwt.assemble_bwt), and checks that both give the
same arrays.  The host's parts are timed by calling them one after the
other: the dict layout alone (ops/bwt.suffix_layout: native SA-IS + LCP
and the groups), the layout with the emission fan-out (ops/bwt._emissions;
the fan-out is the difference), the lexsort of its emissions alone, and
the whole assembly (the gathers, the SA and the run sampling are what is
left of it past the fan-out and the lexsort).  Needs a CUDA card.
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size-mb", type=int, default=64)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from pfbwtf_tpu_torch import engine
    from pfbwtf_tpu_torch.ops import bwt
    from pfbwtf_tpu_torch.ops.bwt_dev import assemble_bwt_dev
    from pfbwtf_tpu_torch.ops.parse import ParserParams

    records = chip_smoke.pangenome_records(args.size_mb)
    res = engine.parse_records(
        records, ParserParams(w=chip_smoke.W, p=chip_smoke.P, get_sai=True))
    del records
    pb = engine.parse_bwt(res)
    stage3 = (res.dict_flat(), chip_smoke.W, res.occs.astype(np.int64),
              pb.bwlast, pb.ilist, pb.bwsai, res.n)
    kw = dict(want_sa=True, want_rssa=True)
    del res, pb

    assemble_bwt_dev(*stage3, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = assemble_bwt_dev(*stage3, **kw)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0

    dict_flat, w, occs, _, ilist = stage3[:5]
    t0 = time.perf_counter()
    bwt.suffix_layout(dict_flat, w, occs,
                      small_hint=ilist.shape[0] < 2**31 - 8)
    t1 = time.perf_counter()
    _, gid, _, _, E_suffix, E_j = bwt._emissions(dict_flat, w, occs, ilist)
    t2 = time.perf_counter()
    np.lexsort((E_j, gid[E_suffix]))
    t3 = time.perf_counter()
    del gid, E_suffix, E_j
    host = bwt.assemble_bwt(*stage3, **kw)
    t4 = time.perf_counter()
    for f in ("bwt", "sa", "ssa", "esa"):
        if not np.array_equal(getattr(host, f), getattr(dev, f)):
            print(f"host and card differ in {f}", file=sys.stderr)
            return 1
    layout_s, emissions_s, lexsort_s, host_s = (t1 - t0, t2 - t1, t3 - t2,
                                                t4 - t3)
    print(f"{torch.cuda.get_device_name(0)}; n={stage3[-1]} dict bytes="
          f"{dict_flat.shape[0]} emissions={stage3[-1] + 1} "
          f"runs={host.nruns}")
    print(f"stage 3 on the card (assemble_bwt_dev, download and run "
          f"sampling included): {dev_s:.4f} s")
    print(f"stage 3 on the host (ops/bwt.assemble_bwt): {host_s:.4f} s, "
          f"the card's arrays; {host_s / dev_s:.1f}x the card's time")
    print(f"  dict layout (native SA-IS + LCP, groups): {layout_s:.4f} s")
    print(f"  emission fan-out: {emissions_s - layout_s:.4f} s")
    print(f"  lexsort of the {stage3[-1] + 1} emissions: {lexsort_s:.4f} s")
    print(f"  the rest (gathers, SA, run sampling): "
          f"{host_s - emissions_s - lexsort_s:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
