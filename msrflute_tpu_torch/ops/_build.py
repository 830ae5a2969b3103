"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<digest>.so`` (the digest
covers the source and the flags, so an edited source never loads a stale
library), then loaded with ``ctypes``.  No PyTorch headers are included, so
a build takes seconds.  Builds happen at first use, never at import.  A
source named in :data:`PARTS`, whose template instances take most of the
build, is compiled as that many objects at once (``-DKERNEL_PART=<i>``,
each holding one share of the instances) and linked into its one
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: sources compiled in parts: ``{name: number of KERNEL_PART objects}``
PARTS = {"flash_attention": 3}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                + str(PARTS.get(name, 1)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _popen(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(name: str) -> Optional[Tuple[List[subprocess.Popen], str, str]]:
    """The source's ``nvcc`` processes, started: one that writes the
    library, or one an object of a source in :data:`PARTS`."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    if name not in PARTS:
        return [_popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src])], tmp, out
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [_popen([nvcc_path(), *flags, "-c", f"-DKERNEL_PART={i}",
                    "-o", f"{tmp}.{i}.o", src])
            for i in range(PARTS[name])], tmp, out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source (per object of a source in :data:`PARTS`, then one link), all
    started together.  Returns each build's compiler output (``ptxas``
    register and spill report included); raises on a failure."""
    procs = {name: _start(name) for name in names}
    logs = {}
    for name, started in procs.items():
        if started is None:
            logs[name] = "cached"
            continue
        running, tmp, out = started
        texts = []
        for proc in running:
            texts.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{texts[-1]}")
        if name in PARTS:
            objs = [f"{tmp}.{i}.o" for i in range(PARTS[name])]
            link = _popen([nvcc_path(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                           *objs])
            texts.append(link.communicate()[0])
            for obj in objs:
                os.remove(obj)
            if link.returncode != 0:
                raise RuntimeError(f"linking {name} failed:\n{texts[-1]}")
        os.replace(tmp, out)
        logs[name] = "".join(texts)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(library_path(name))
    return _loaded[name]
