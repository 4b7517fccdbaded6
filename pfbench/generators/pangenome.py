"""A pan-genome: mutated copies of one random ACGT genome, as a FASTA.

``haplotypes`` copies (the traffic's) of one uniform random unit of
``text_bp / haplotypes`` bases (``text_bp`` is the configuration's
scale), each with ``int(unit * snp_rate)`` substitutions at independent
uniform positions (a substitution may redraw the same base), one record
a copy on one line. This is the input of bench.py's
``make_pangenome_input`` (8 copies at 0.001, there with seed 4321),
drawn here from the run's seed.
"""

import os

import numpy as np


def make(config: dict, traffic: dict, seed: int, workdir: str) -> dict:
    """Write ``collection.fa`` under ``workdir``; return its path, the
    record lengths and the input bases."""
    copies = int(traffic["haplotypes"])
    unit_bp = int(config["text_bp"]) // copies
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    unit = acgt[rng.integers(0, 4, size=unit_bp)]
    nmut = int(unit_bp * float(traffic["snp_rate"]))
    path = os.path.join(workdir, "collection.fa")
    with open(path, "wb") as f:
        for i in range(copies):
            hap = unit.copy()
            hap[rng.integers(0, unit_bp, size=nmut)] = acgt[
                rng.integers(0, 4, size=nmut)]
            f.write(b">hap%d\n" % i + hap.tobytes() + b"\n")
    return {"fasta": path, "lengths": [unit_bp] * copies,
            "bases": unit_bp * copies}
