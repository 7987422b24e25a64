"""Build the hand-written CUDA kernels and bind them with ctypes.

Each source in csrc/ is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface, at first use, into `_build/` beside
this file (listed in .gitignore). A library's file name carries a hash
of its source, the csrc/ headers it includes (philox.cuh,
attn_tiles.cuh, mma_tiles.cuh, attn_mma.cuh, row_chunks.cuh) and the
flags, so an edited source or header is rebuilt. `build()` starts one
nvcc process per source, all at once. Nothing here runs at import time:
the CPU tests import every module on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..errors import PreconditionNotMetError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "flash_tiled", "fused_dropout_add_ln",
           "layer_norm", "ring_block", "sum_partials")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise PreconditionNotMetError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA toolkit is needed to build the kernels"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name, csrc):
    """The .cu file of `name` and every header of `csrc` it includes,
    directly or through another header, in a fixed order."""
    seen, order = set(), []
    todo = [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        path = csrc / rel
        if rel in seen or not path.exists():
            continue
        seen.add(rel)
        order.append(path)
        todo += [m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return order


def lib_path(name, csrc=CSRC):
    """The library of `name`; its file name carries a hash of the source,
    every header it includes from `csrc`, and the flags, so an edit to
    any of them builds anew."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES):
    """Compile every named source whose library is missing, one nvcc
    process each, all started together. Returns {name: (seconds, ptxas
    report)} for what was compiled; raises on a failed compile."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, stderr)
    if failed:
        raise PreconditionNotMetError("\n".join(failed))
    return report


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
