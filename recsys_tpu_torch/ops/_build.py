"""Build ``recsys_tpu_torch/csrc/*.cu`` with ``nvcc`` on first use and
load the result with ctypes.

Each source compiles to an object file in its own ``nvcc`` process, all
started together, and the objects link into one shared library with a
plain C interface. The library's name carries a hash of the sources, the
headers they share (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged one is loaded
from ``build/torch_kernels/`` at the root of the checkout. Nothing is
downloaded; only the repository's own sources are compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of recsys_tpu_torch are built from source on first use"
    )


def headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    lib = BUILD_DIR / f"librecsys_kernels_{_digest(srcs)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        errors = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name}:\n{out}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, loaded once."""
    return ctypes.CDLL(str(build()))
