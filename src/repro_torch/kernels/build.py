"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes a shared library of its own with a plain C
interface (no PyTorch headers, so nvcc takes seconds), compiled for
``sm_90a`` at the first launch into ``build/repro_torch/`` at the root of
the checkout, which .gitignore lists.  The sources include the headers of
``csrc/`` (``*.cuh``), which is on nvcc's include path.  The library's file
name carries a hash of its source, the headers and the flags: an edited
source or header is rebuilt, an unchanged one is loaded as it is.  Nothing here runs at import, so the CPU tests import
the package on a machine with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("weighted_agg", "weighted_agg_quant", "masked_sgd",
           "flash_attention", "ssd_intra_chunk")
# -Xptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def compile_source(src: Path, target: Path) -> subprocess.Popen:
    """Starts nvcc on one source into the library ``target``, with the
    flags above and ``csrc/``'s headers on the include path (``src`` may lie
    elsewhere); the caller waits for it (stdout holds nvcc's report)."""
    return subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(target), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile each named source that has no up-to-date library: one nvcc
    per source, all started together.  Returns nvcc's report (the ptxas
    lines) for each source compiled; raises if any compile failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        # a private temporary name, renamed into place once complete, so a
        # concurrent build never loads a half-written library
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        jobs[name] = (target, tmp, compile_source(CSRC / f"{name}.cu", tmp))
    reports, failed = {}, []
    for name, (target, tmp, proc) in jobs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"{n}.cu:\n{reports[n]}" for n in failed))
    return reports


def load(name: str,
         signatures: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to its ctypes argument types
    (``c_void_p`` for pointers and the stream, so none is cut to 32 bits);
    every function returns an int, the launch's cudaGetLastError()."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = _libs[name] = open_library(library_path(name), signatures)
    return lib


def open_library(path: Path,
                 signatures: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The library at ``path`` with the argument and result types of its
    functions set from ``signatures`` (see ``load``)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib
