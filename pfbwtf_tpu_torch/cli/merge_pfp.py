"""merge_pfp CLI of the port (src/merge_pfp.cpp:22-72 flag surface):

    python -m pfbwtf_tpu_torch.cli.merge_pfp [options] <prefix>...

Merges saved parses (a prefix with no .dict/.parse is read as a FASTA)
into one parse and writes its .dict/.occ/.parse/.n[/.docs], and with
``--parse-bwt`` its .bwlast/.ilist[/.bwsai].  The rescan (kernel K1), the
dedup and the parse-BWT run on the card (``device``); ``-t`` is accepted
and changes nothing, as in pfbwtf_tpu.

A run is one build (utils/timer.build): the merge's spans ``merge.rebuild``,
``merge.scan`` and ``merge.dedup`` (parallel/merge.py), ``merge.save_parse``
(.dict .occ .parse .n [.docs]), then with ``--parse-bwt`` stage 2's
``staged.parse_bwt`` and ``staged.save_parse_bwt`` (pipeline.save_parse_bwt,
the staged build's own code); counters ``merge_prefixes``,
``rebuilt_bytes``, ``ckpt_bytes`` (files written) and the host reads'
``syncs`` and ``d2h_bytes``.
"""

import argparse
import sys

from ..io import formats
from ..ops.parse import ParserParams
from ..parallel.merge import merge_parse_prefixes
from ..pipeline import save_parse_bwt, save_parser
from ..utils.errors import PfbwtError
from ..utils.malloc_tuning import tune_malloc
from ..utils.timer import build, span


def main(argv=None, device="cuda", info: dict = None):
    """``info`` receives merge_parse_prefixes's keys (peak_merge among
    them), parse_bwt_s and write_s (every file written), with the build's
    spans, counts and build_id."""
    ap = argparse.ArgumentParser(prog="merge_pfp")
    ap.add_argument("prefixes", nargs="+")
    ap.add_argument("-o", "--output", default="out")
    ap.add_argument("-w", "--window-size", type=int, default=10, dest="w")
    ap.add_argument("-p", "--mod-val", type=int, default=100, dest="p")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("-d", "--docs", action="store_true")
    ap.add_argument("-s", "--sai", action="store_true")
    ap.add_argument("--parse-bwt", action="store_true")
    ap.add_argument("--u32", action="store_true")
    args = ap.parse_args(argv)
    tune_malloc()  # numpy temporaries reuse the heap (malloc_tuning.py)
    dtype = formats.U32 if args.u32 else formats.U64
    params = ParserParams(
        w=args.w, p=args.p, get_sai=args.sai, store_docs=args.docs
    )
    info = {} if info is None else info
    try:
        with build(info):
            res = merge_parse_prefixes(args.prefixes, params, device=device,
                                       info=info)
            with span("merge.save_parse") as write:
                save_parser(res, args.output, dtype)
            info["write_s"] = write.seconds
            if args.parse_bwt:
                save_parse_bwt(res, args.output, dtype, sa=args.sai,
                               device=device, info=info)
    except PfbwtError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
