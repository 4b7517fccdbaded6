"""``pfbwt_f -s -r``: the staged build, from the FASTA file to the eleven
files, through the port's CLI.

A build calls ``pfbwtf_tpu_torch.cli.pfbwt_f.main`` with the
configuration's arguments and ``-o <workdir>/build<i>``, as a user runs
the command: stages 1 and 2 write the seven checkpoint files (``.dict
.occ .parse .n .bwlast .ilist .bwsai``), stage 3 reads them back and
writes ``.bwt .sa .ssa .esa`` (about 3.4 GB a build at the
configuration's size). The harness's span ``fsync`` then flushes the
eleven files to the disk, so that a build pays for its own writes. Build
i's files are deleted when build i + 1 starts, unless the check keeps
them; the check reads all eleven back. The reference is
``drivers/fused.py``'s for the four outputs and ``reference/pfp.py`` for
the seven checkpoint files.
"""

import os

import numpy as np

from ..compare import differences
from ..reference import pfp
from ..reference.text import collection_text, read_fasta
from . import fused

CKPT = {"dict": np.uint8, "occ": np.uint64, "parse": np.uint32,
        "n": np.uint8, "bwlast": np.uint8, "ilist": np.uint64,
        "bwsai": np.uint64}
OUTS = {"bwt": np.uint8, "sa": np.uint64, "ssa": np.uint64,
        "esa": np.uint64}
FILES = {**OUTS, **CKPT}


class Driver:
    def __init__(self, config: dict, inputs: dict, workdir: str, device):
        from pfbwtf_tpu_torch.cli import pfbwt_f

        self._main = pfbwt_f.main
        self.args = list(config["cli"][1:])
        self.fasta = inputs["fasta"]
        self.device = device
        self.workdir, self.keep = workdir, set()
        self.released_bytes = 0

    def path(self, i: int, ext: str) -> str:
        return os.path.join(self.workdir, f"build{i}.{ext}")

    def prefix(self, i: int) -> str:
        return os.path.join(self.workdir, f"build{i}")

    def build(self, i: int, span):
        self.release(i - 1)
        info = {}
        with span("build"):
            rc = self._main([*self.args, "-o", self.prefix(i), self.fasta],
                            device=self.device, info=info)
        if rc != 0:
            raise RuntimeError(f"pfbwt_f exited {rc}")
        with span("fsync"):
            for ext in FILES:
                fd = os.open(self.path(i, ext), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        return i, info

    def outputs(self, i: int, res) -> dict:
        """The eleven written files read back (the uint32 ``.parse`` as
        int64)."""
        out = {ext: np.fromfile(self.path(i, ext), dtype=dt)
               for ext, dt in FILES.items()}
        out["parse"] = out["parse"].astype(np.int64)
        return out

    def release(self, i: int):
        if i in self.keep:
            return
        for ext in FILES:
            path = self.path(i, ext)
            if os.path.exists(path):
                self.released_bytes += os.path.getsize(path)
                os.remove(path)


def reference(config: dict, inputs: dict, device, max_rounds=None):
    """``drivers/fused.py``'s four outputs and sizes, and the seven
    checkpoint files worked out again from the FASTA; with
    ``max_rounds``, the control's (both suffix sorts stopped early)."""
    want, sizes = fused.reference(config, inputs, device, max_rounds)
    seqs = [s for _, s in read_fasta(inputs["fasta"])]
    text = collection_text(seqs, int(config["w"]))
    want.update(pfp.checkpoint_files(text, int(config["w"]),
                                     int(config["p"]), device, max_rounds))
    return want, sizes


def check(got: dict, want: dict) -> dict:
    """One number a file: differing entries plus the length difference."""
    return {k: differences(got[k], want[k]) for k in FILES}
