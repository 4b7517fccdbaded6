"""``pfbwt_f --fused -s -r``: the whole build on the card, from the FASTA
file to the BWT, the SA and its run-length samples in host memory.

A build reads the FASTA again (``io.fasta.read_fasta_bytes``) and calls
``ops.fused.pfbwt_fused_records`` with the ``ParserParams`` that
``cli/pfbwt_f._run_fused`` builds. The files are not written: each build
of a window would write some 2.4 GB (the ``.bwt`` and the 8-byte ``.sa``).
"""

import torch

from ..compare import differences
from ..reference import sa as ref_sa
from ..reference.text import collection_text, read_fasta


class Driver:
    def __init__(self, config: dict, inputs: dict, workdir: str, device):
        from pfbwtf_tpu_torch.io.fasta import read_fasta_bytes
        from pfbwtf_tpu_torch.ops.fused import pfbwt_fused_records
        from pfbwtf_tpu_torch.ops.parse import ParserParams

        self._read = read_fasta_bytes
        self._build = pfbwt_fused_records
        self.params = ParserParams(w=int(config["w"]), p=int(config["p"]),
                                   non_acgt_to_a=False, verbose=False)
        self.fasta = inputs["fasta"]
        self.device = device
        self.released_bytes = 0  # a build writes no file

    def build(self, i: int, span):
        with span("read_fasta"):
            records = self._read(self.fasta)
        with span("build"):
            return self._build(records, self.params, device=self.device,
                               want_sa=True, want_rssa=True)

    def outputs(self, i: int, res) -> dict:
        return {"bwt": res.bwt, "sa": res.sa, "ssa": res.ssa, "esa": res.esa}

    def release(self, i: int):
        pass


def reference(config: dict, inputs: dict, device, max_rounds=None):
    """The outputs worked out again from the FASTA, and the input's sizes;
    with ``max_rounds``, the control's."""
    seqs = [s for _, s in read_fasta(inputs["fasta"])]
    text = collection_text(seqs, int(config["w"]))
    sa, rounds = ref_sa.suffix_array(text, device, max_rounds)
    bwt = ref_sa.bwt_of(torch.from_numpy(text).to(device), sa)
    ssa, esa = ref_sa.run_samples(bwt, sa)
    sizes = {"text_n": int(text.shape[0]),
             "bases": int(sum(s.shape[0] for s in seqs)), "rounds": rounds}
    return {"bwt": bwt, "sa": sa, "ssa": ssa, "esa": esa}, sizes


def check(got: dict, want: dict) -> dict:
    return {k: differences(got[k], want[k]) for k in ("bwt", "sa", "ssa", "esa")}
