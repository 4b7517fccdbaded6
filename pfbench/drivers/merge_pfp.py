"""``merge_pfp -s --parse-bwt --docs`` over one saved parse a haplotype,
then ``pfbwt_f --pfbwt-only -s -r``: the merge workflow of pfbwt-f's
vcf_to_bwt.py (:230-258), through the port's two CLIs.

Set-up splits the generator's FASTA into one FASTA a record (a haplotype)
and parses each with the configuration's ``shard_cli`` (``pfbwt_f
--parse-only --print-docs -s``) into ``shard<i>``, as other workers or
earlier runs would have made them; the shard parses are inputs, kept for
the whole run. A build calls ``cli/merge_pfp.main`` with the prefixes and
``-o <workdir>/build<i>``, then ``cli/pfbwt_f.main`` ``--pfbwt-only`` on
the merged files, under the harness's span ``build``; the harness's span
``fsync`` then flushes the twelve files it wrote (the seven checkpoint
files, ``.docs``, ``.bwt .sa .ssa .esa``). A build's ``info`` is both
commands' ``info``: seconds summed by key, spans one after the other,
counters summed by name (spans and counters only where both commands
hand them back). Build i's files are deleted when build i + 1 starts,
unless the check keeps them. The reference is ``drivers/staged.py``'s,
whose parse of the whole collection is what the merge must equal, and
``reference/merge.py``'s ``.docs``.
"""

import os

import numpy as np
import torch

from ..compare import differences
from ..reference.merge import docs_file
from ..reference.text import read_fasta
from . import staged

FILES = {**staged.FILES, "docs": np.uint8}


def split_fasta(path: str, workdir: str) -> list:
    """One FASTA a record of ``path``, ``hap<i>.fa`` under ``workdir``, the
    record's bytes as they are; returns their paths."""
    with open(path, "rb") as f:
        data = f.read()
    paths = []
    for i, body in enumerate(data.split(b">")[1:]):
        out = os.path.join(workdir, f"hap{i}.fa")
        with open(out, "wb") as f:
            f.write(b">" + body)
        paths.append(out)
    return paths


def joined_info(first: dict, second: dict) -> dict:
    """Two commands' ``info`` as one build's: float seconds summed by key,
    spans one after the other (the second's parents moved past the
    first's), counters summed by name; spans and counters only where both
    have them."""
    out = {**first, **second}
    for k in first.keys() & second.keys():
        if isinstance(first[k], float) and isinstance(second[k], float):
            out[k] = first[k] + second[k]
    out.pop("spans", None)
    out.pop("counts", None)
    out["build_id"] = (first.get("build_id"), second.get("build_id"))
    if "spans" in first and "spans" in second:
        off = len(first["spans"])
        out["spans"] = list(first["spans"]) + [
            (n, None if p is None else p + off, t0, t1)
            for n, p, t0, t1 in second["spans"]]
    if "counts" in first and "counts" in second:
        counts = dict(first["counts"])
        for k, v in second["counts"].items():
            counts[k] = counts.get(k, 0) + v
        out["counts"] = counts
    return out


class Driver:
    def __init__(self, config: dict, inputs: dict, workdir: str, device):
        from pfbwtf_tpu_torch.cli import merge_pfp, pfbwt_f

        self._merge, self._pfbwt = merge_pfp.main, pfbwt_f.main
        merge_cli, pfbwt_cli = config["cli"]
        self.merge_args, self.pfbwt_args = merge_cli[1:], pfbwt_cli[1:]
        self.device = device
        self.workdir, self.keep = workdir, set()
        self.released_bytes = 0
        fastas = split_fasta(inputs["fasta"], workdir)
        if len(fastas) != int(config["shards"]):
            raise ValueError(f"{len(fastas)} records for "
                             f"{config['shards']} shards")
        self.shards = []
        for i, fa in enumerate(fastas):
            prefix = os.path.join(workdir, f"shard{i}")
            rc = pfbwt_f.main([*config["shard_cli"][1:], "-o", prefix, fa],
                              device=device)
            if rc != 0:
                raise RuntimeError(f"pfbwt_f exited {rc} on shard {i}")
            self.shards.append(prefix)

    def path(self, i: int, ext: str) -> str:
        return os.path.join(self.workdir, f"build{i}.{ext}")

    def prefix(self, i: int) -> str:
        return os.path.join(self.workdir, f"build{i}")

    def build(self, i: int, span):
        self.release(i - 1)
        merged, pfbwt = {}, {}
        with span("build"):
            rc = self._merge([*self.shards, "-o", self.prefix(i),
                              *self.merge_args], device=self.device,
                             info=merged)
            if rc != 0:
                raise RuntimeError(f"merge_pfp exited {rc}")
            rc = self._pfbwt([*self.pfbwt_args, "-o", self.prefix(i)],
                             device=self.device, info=pfbwt)
            if rc != 0:
                raise RuntimeError(f"pfbwt_f --pfbwt-only exited {rc}")
        with span("fsync"):
            for ext in FILES:
                fd = os.open(self.path(i, ext), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
        return i, joined_info(merged, pfbwt)

    def outputs(self, i: int, res) -> dict:
        """The twelve written files read back (the uint32 ``.parse`` as
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
    """``drivers/staged.py``'s eleven files of the whole collection (the
    merge must equal its parse) and the merged ``.docs`` of its records;
    with ``max_rounds``, the control's."""
    want, sizes = staged.reference(config, inputs, device, max_rounds)
    docs = docs_file(read_fasta(inputs["fasta"]), int(config["w"]))
    want["docs"] = torch.from_numpy(docs).to(device)
    return want, sizes


def check(got: dict, want: dict) -> dict:
    """One number a file: differing entries plus the length difference."""
    return {k: differences(got[k], want[k]) for k in FILES}
