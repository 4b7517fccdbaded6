"""``vcf_to_bwt``: a reference FASTA and a phased VCF panel to the BWT, its
run-length SA samples and the marker array, every file written.

The configuration's ``cli`` is handed to ``cli/vcf_to_bwt.main`` once, with
the pipeline swapped for a stand-in that keeps the ``VcfToBwtConfig`` the
CLI builds; each build then calls ``vcf.pipeline.vcf_to_bwt`` on that
config, with the build's own output prefix under the run's work directory.
Build i's files are deleted once build i + 1 is done, unless the check
keeps them.
"""

import dataclasses
import os

import numpy as np
import torch

from ..compare import differences, text_differences
from ..reference import panel as ref_panel
from ..reference import sa as ref_sa
from ..reference.text import collection_text, read_fasta

FILES = ("bwt", "ssa", "esa", "mps", "ma")


class Driver:
    def __init__(self, config: dict, inputs: dict, workdir: str, device):
        from pfbwtf_tpu_torch.cli import vcf_to_bwt as cli
        from pfbwtf_tpu_torch.vcf.pipeline import vcf_to_bwt

        made = []
        run = cli.vcf_to_bwt
        cli.vcf_to_bwt = made.append
        try:
            argv = [inputs["fasta"], inputs["vcf"], "-o",
                    os.path.join(workdir, "out")] + list(config["cli"][1:])
            rc = cli.main(argv, device=device)
        finally:
            cli.vcf_to_bwt = run
        if rc != 0 or len(made) != 1:
            raise RuntimeError(f"vcf_to_bwt {argv}: exit code {rc}")
        self.cfg = made[0]
        self._run = vcf_to_bwt
        self.inputs, self.workdir, self.keep = inputs, workdir, set()
        self.released_bytes = 0

    def prefix(self, i: int) -> str:
        return os.path.join(self.workdir, f"build{i}")

    def build(self, i: int, span):
        if i > 0 and i - 1 not in self.keep:
            self.release(i - 1)
        info = {}
        with span("build"):
            res = self._run(dataclasses.replace(self.cfg, output=self.prefix(i)),
                            info)
        return res, info

    def outputs(self, i: int, res) -> dict:
        out = {"sa": res.sa}
        for ext in FILES:
            dtype = np.uint8 if ext == "bwt" else np.uint64
            out[ext] = np.fromfile(f"{self.prefix(i)}.{ext}", dtype=dtype)
        return out

    def release(self, i: int):
        for ext in FILES + ("log",):
            path = f"{self.prefix(i)}.{ext}"
            if os.path.exists(path):
                self.released_bytes += os.path.getsize(path)
                os.remove(path)


def reference(config: dict, inputs: dict, device, max_rounds=None):
    """The haplotype text, its SA, BWT, run samples, .mps and .ma worked
    out again from the FASTA and the VCF, and the input's sizes; with
    ``max_rounds``, the control's."""
    if int(config["ma_wsize"]) != 1:
        raise ValueError("the reference's markers cover one position each")
    w = int(config["w"])
    seqs, pos, val, mps = ref_panel.panel(read_fasta(inputs["fasta"]),
                                          inputs["vcf"], w)
    text = collection_text(seqs, w)
    sa, rounds = ref_sa.suffix_array(text, device, max_rounds)
    text_t = torch.from_numpy(text).to(device)
    bwt = ref_sa.bwt_of(text_t, sa)
    ssa, esa = ref_sa.run_samples(bwt, sa)
    ma = ref_panel.marker_array(sa, pos, val)
    sizes = {"text_n": int(text.shape[0]),
             "bases": int(sum(s.shape[0] for s in seqs)), "rounds": rounds}
    return {"text": text_t, "sa": sa, "bwt": bwt, "ssa": ssa, "esa": esa,
            "mps": torch.from_numpy(mps.view(np.int64)).to(device),
            "ma": torch.from_numpy(ma.view(np.int64)).to(device)}, sizes


def check(got: dict, want: dict) -> dict:
    out = {"text": text_differences(got["bwt"], got["sa"], want["text"])}
    out.update({k: differences(got[k], want[k]) for k in FILES})
    return out
