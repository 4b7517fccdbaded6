"""Build the CUDA sources in ``pfbwtf_tpu_torch/csrc/`` at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/pfbwtf_tpu_torch/<name>-<hash>.so``
at the repository root, and is loaded with ctypes.  The hash covers the
source's content and the flags, so an edited source is rebuilt and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises.
``functions`` hands the wrappers their C functions, resolved once per
library load, and ``current_stream`` a card's current stream.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pfbwtf_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs = {}
build_logs = {}  # name -> nvcc's output (ptxas register/shared-memory lines)


def sources():
    """Names of the kernels in csrc/ (one shared library per source)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pfbwtf_tpu_torch are built "
            "from csrc/ at first use and need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> str:
    """Build csrc/<name>.cu if its library is missing; return the path."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True,
    )
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{build_logs[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built at first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(library_path(name))
    return _libs[name]


_functions = {}  # name -> (library, {symbol: ctypes function})


def functions(name: str, signatures: dict) -> dict:
    """The C functions of csrc/<name>.cu by symbol, each resolved and given
    its ``(argtypes, restype)`` from ``signatures`` once per library load,
    so that a launch costs a dictionary lookup, not a symbol lookup."""
    lib = load(name)
    held = _functions.get(name)
    if held is None or held[0] is not lib:
        fns = {}
        for symbol, (argtypes, restype) in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            fns[symbol] = fn
        held = _functions[name] = (lib, fns)
    return held[1]


def current_stream(dev: int) -> int:
    """The handle of PyTorch's current stream on card ``dev``, the stream
    ``torch.cuda.current_stream(dev).cuda_stream`` names, read without
    building a Stream object: 0.20-0.23 us a call against 5.5-7.2 us on
    the host of an NVIDIA H100 80GB HBM3 at 700 W
    (scripts/gather_launch_cost.py)."""
    return torch._C._cuda_getCurrentRawStream(dev)


def build_all() -> float:
    """Build every source in csrc/ at once (one nvcc each, all started
    together); returns the wall seconds."""
    t0 = time.perf_counter()
    names = sources()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(library_path, names))
    return time.perf_counter() - t0
