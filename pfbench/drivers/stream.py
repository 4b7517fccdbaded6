"""``pfbwt_f --fused -m -s -r``: the streamed build, from the FASTA file to
the ``.bwt``, ``.sa``, ``.ssa`` and ``.esa`` written to files.

A build reads the FASTA again (``io.fasta.read_fasta_bytes``) and calls
``ops.fused_stream.pfbwt_fused_stream_records`` with the ``ParserParams``
that ``cli/pfbwt_f._run_fused`` builds. The entry opens and writes
``build<i>.bwt``, ``.sa``, ``.ssa`` and ``.esa`` under the run's work
directory, as the CLI writes its four files (about 4.3 GB a build at the
configuration's size); the harness's span ``fsync`` then flushes them to
the disk, so that a build pays for its own writes and leaves no dirty
pages to the runs after it. Build i's files are deleted when build i + 1
starts, unless the check keeps them; the check reads them back. The
reference and the check are the fused driver's: the same text, the same
four outputs.
"""

import os

import numpy as np

from .fused import check, reference  # noqa: F401  (found by name)

EXTS = ("bwt", "sa", "ssa", "esa")


class Driver:
    def __init__(self, config: dict, inputs: dict, workdir: str, device):
        from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
        from pfbwtf_tpu_torch.ops import fused_stream
        from pfbwtf_tpu_torch.ops.parse import ParserParams

        self._read = read_fasta_bytes
        self._build = fused_stream.pfbwt_fused_stream_records
        self.params = ParserParams(w=int(config["w"]), p=int(config["p"]),
                                   non_acgt_to_a=False, verbose=False)
        self.fasta = inputs["fasta"]
        self.device = device
        self.workdir, self.keep = workdir, set()
        self.released_bytes = 0

    def path(self, i: int, ext: str) -> str:
        return os.path.join(self.workdir, f"build{i}.{ext}")

    def build(self, i: int, span):
        self.release(i - 1)
        with span("read_fasta"):
            records = self._read(self.fasta)
        with span("build"):
            res = self._build(records, self.params,
                              open_out=lambda ext: open(self.path(i, ext),
                                                        "wb"),
                              want_sa=True, want_rssa=True,
                              device=self.device)
        with span("fsync"):
            for ext in EXTS:
                fd = os.open(self.path(i, ext), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        return res

    def outputs(self, i: int, res) -> dict:
        """The four written files read back."""
        return {"bwt": np.fromfile(self.path(i, "bwt"), dtype=np.uint8),
                **{ext: np.fromfile(self.path(i, ext), dtype=np.uint64)
                   for ext in EXTS[1:]}}

    def release(self, i: int):
        if i in self.keep:
            return
        for ext in EXTS:
            path = self.path(i, ext)
            if os.path.exists(path):
                self.released_bytes += os.path.getsize(path)
                os.remove(path)
