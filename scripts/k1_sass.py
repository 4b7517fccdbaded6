#!/usr/bin/env python3
"""The SASS of kernel K1 (csrc/hash_scan.cu) as built for sm_90a.

    python scripts/k1_sass.py [--out FILE]

Builds the kernel as the port does (ops/cuda/build.py), disassembles the
library with ``cuobjdump -sass``, writes the whole listing to FILE
(default build/k1_sass.txt) and prints, for each instance of the
kernel template (kWide: w > 16; kSwap: p has 2^32 as a factor):

- the instruction count of each opcode;
- the hot path: the instructions that a thread whose 16-byte loads and
  stores are all whole issues for its run of positions.  It is the path
  from the entry through every block with a 16-byte load or store (in
  address order) to an EXIT that enters no block with a byte load or
  store (the edges of the input), the shortest such path between each
  pair.  Its count over the run length (kRun in the source) is the
  instructions issued per position, the thread's set-up included, next
  to the opcode mix per position and the number of backward branches on
  it (a loop whose trip count grows with w would show there);
- the work: the hot path less what loads, packs and realigns codes,
  stores, reads parameters, moves registers, runs on the uniform
  datapath, forms addresses or steers (``NOT_WORK``).  What is left is
  the k-mer's extraction, the Wang mix, the divisibility test and the
  flag as compiled; its count a position is the one in
  chip_smoke.k1_ops_per_position, from which K1's bound is taken.

Last it builds a probe that applies the kernel's own ``wang64`` to one
word a thread and prints the instructions that the mix takes, for a
64-bit key and for a key whose high word is 0 (w <= 16): the mix taken
apart from the kernel, which spends fewer in the fused work above.
Needs the CUDA toolkit (nvcc, cuobjdump); no card.
"""

import argparse
import collections
import heapq
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_INSN = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
# opcode prefixes that are not the cut scan's work: loads and packing of
# codes (PRMT; SHF.L.W realigns the packed words by the input's offset),
# stores, parameter reads, register moves, the uniform datapath, address
# arithmetic (VIADD, sign extensions, the thread's first position) and
# control
NOT_WORK = ("LDG", "STG", "LDC", "PRMT", "SHF.L.W", "MOV", "IMAD.MOV",
            "CS2R", "U", "S2R", "S2UR", "VIADD", "LEA.HI.X.SX32",
            "SHF.R.S32", "IMAD.SHL", "BRA", "BSSY", "BSYNC", "EXIT", "ISETP",
            "SEL", "NOP")
_GATHER = "0x40100401"  # pack16's multiplier: an IMAD of the packing


_PROBE = r"""
#include "{src}"
__global__ void probe_copy(const uint64_t* in, uint64_t* out) {{
  out[threadIdx.x] = in[threadIdx.x];
}}
__global__ void probe_wang64(const uint64_t* in, uint64_t* out) {{
  out[threadIdx.x] = wang64(in[threadIdx.x]);
}}
__global__ void probe_wang32(const uint64_t* in, uint64_t* out) {{
  out[threadIdx.x] = wang64(static_cast<uint32_t>(in[threadIdx.x]));
}}
"""


def functions(sass: str) -> dict:
    """{function name: [(address, predicated, opcode, operands)]}."""
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), bool(m.group(2)), m.group(3),
                        m.group(4)))
    return out


def blocks(insns):
    """Basic blocks {start address: [insn, ...]} and their successors."""
    addrs = [a for a, *_ in insns]
    leaders = {addrs[0]}
    for i, (a, pred, op, args) in enumerate(insns):
        if op.startswith(("BRA", "EXIT", "RET")):
            if i + 1 < len(insns):
                leaders.add(addrs[i + 1])
            if op.startswith("BRA"):
                leaders.add(int(_TARGET.search(args).group(1), 16))
    body, succ, cur = {}, {}, None
    for ins in insns:
        if ins[0] in leaders:
            cur = ins[0]
            body[cur] = []
        body[cur].append(ins)
    starts = sorted(body)
    for i, b in enumerate(starts):
        a, pred, op, args = body[b][-1]
        nxt = starts[i + 1] if i + 1 < len(starts) else None
        out = []
        if op.startswith("BRA"):
            out.append(int(_TARGET.search(args).group(1), 16))
            if pred and nxt is not None:
                out.append(nxt)
        elif op.startswith(("EXIT", "RET")):
            if pred and nxt is not None:
                out.append(nxt)
        elif nxt is not None:
            out.append(nxt)
        succ[b] = out
    return body, succ


def _has(block, unit: str, ops=("LDG", "STG")) -> bool:
    return any(op.startswith(ops) and f".{unit}" in op
               for _, _, op, _ in block)


def hot_path(body, succ):
    """Block starts of the hot path, or None if the listing has no such
    path."""
    cold = {b for b, blk in body.items() if _has(blk, "U8")}
    need = sorted(b for b, blk in body.items() if _has(blk, "128"))
    ends = {b for b, blk in body.items()
            if any(op.startswith("EXIT") for _, _, op, _ in blk)}

    def shortest(src, goals):
        dist = {src: len(body[src])}
        prev = {}
        heap = [(dist[src], src)]
        while heap:
            d, b = heapq.heappop(heap)
            if b in goals:
                path = [b]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            if d > dist[b]:
                continue
            for c in succ[b]:
                if c in cold or c not in body:
                    continue
                nd = d + len(body[c])
                if nd < dist.get(c, 1 << 60):
                    dist[c], prev[c] = nd, b
                    heapq.heappush(heap, (nd, c))
        return None

    path = [min(body)]
    for goal in need + [None]:
        leg = shortest(path[-1], ends if goal is None else {goal})
        if leg is None:
            return None
        path += leg[1:]
    return path


def path_count(insns) -> list:
    """The instructions of the hot path, or [] if there is none."""
    body, succ = blocks(insns)
    path = hot_path(body, succ)
    return [ins for b in path for ins in body[b]] if path else []


def work(hot) -> list:
    """The instructions of the hot path that are the cut scan's work."""
    return [ins for ins in hot if not (
        ins[2].startswith(NOT_WORK)
        or (ins[2] == "IMAD" and _GATHER in ins[3]))]


def wang_counts(build, sass_tool: str) -> tuple:
    """Instructions of wang64 on a 64-bit key and on a 32-bit key: each
    probe's path less the plain copy's."""
    src = os.path.join(build.CSRC, "hash_scan.cu")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    probe = os.path.join(build.BUILD_DIR, "k1_probe.cu")
    cubin = os.path.join(build.BUILD_DIR, "k1_probe.cubin")
    with open(probe, "w") as f:
        f.write(_PROBE.format(src=src))
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, probe],
                   capture_output=True, text=True, check=True)
    sass = subprocess.run([sass_tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    n = {name: len(path_count(insns))
         for name, insns in functions(sass).items()}
    base = next(v for k, v in n.items() if "probe_copy" in k)
    return tuple(next(v for k, v in n.items() if key in k) - base
                 for key in ("probe_wang64", "probe_wang32"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "k1_sass.txt"))
    args = ap.parse_args(argv)

    from pfbwtf_tpu_torch.ops.cuda import build

    lib = build.library_path("hash_scan")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(sass)
    print(f"{lib}; listing in {args.out}")
    with open(os.path.join(build.CSRC, "hash_scan.cu")) as f:
        run = int(re.search(r"constexpr int kRun = (\d+);", f.read())
                  .group(1))
    kernels = {k: v for k, v in functions(sass).items()
               if "cut_scan_kernel" in k}
    if not kernels:
        print("no cut_scan_kernel in the listing")
        return 1
    for name, insns in sorted(kernels.items()):
        m = re.search(r"ILb([01])ELb([01])E", name)
        which = (f"kWide={m.group(1)} kSwap={m.group(2)}" if m else name)
        ops = collections.Counter(op.split(".")[0] for _, _, op, _ in insns)
        print(f"{which}: {len(insns)} instructions: "
              + ", ".join(f"{op} {k}" for op, k in ops.most_common()))
        hot = path_count(insns)
        if not hot:
            print("  hot path: not found in the listing")
            return 1
        back = sum(1 for a, _, op, args in hot if op.startswith("BRA")
                   and int(_TARGET.search(args).group(1), 16) <= a)
        print(f"  hot path: {len(hot)} instructions for a thread's {run} "
              f"positions = {len(hot) / run:.2f} a position (set-up "
              f"included); {back} backward branches")
        mix = collections.Counter(op.split(".")[0] for _, _, op, _ in hot)
        print("  a position: " + ", ".join(
            f"{op} {k / run:.2f}" for op, k in mix.most_common()))
        done = work(hot)
        mix = collections.Counter(op for _, _, op, _ in done)
        print(f"  work: {len(done)} instructions for {run} positions = "
              f"{len(done) / run:.2f} a position: " + ", ".join(
                  f"{op} {k}" for op, k in mix.most_common()))
    w64, w32 = wang_counts(build, tool)
    print(f"wang64: {w64} instructions on a 64-bit key, {w32} on a key "
          "whose high word is 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
