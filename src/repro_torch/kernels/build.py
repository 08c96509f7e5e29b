"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which
:mod:`repro_torch.kernels.ops` calls through ``ctypes``.  A build runs at
first use, into ``<repo>/build/kernels/<name>-<hash>/``, keyed by a hash of
the source and the flags, so an unchanged source is never compiled twice;
:func:`build_all` starts one ``nvcc`` per source, all at once.  Each build
keeps ``nvcc``'s output (with ``ptxas``'s registers, shared memory and
spills per kernel) beside its library, read back by :func:`build_log`.  Nothing here
runs at import time: the CPU tests import this module on machines with no
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "build_log", "load", "nvcc_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES: dict[str, Path] = {name: _CSRC / f"{name}.cu" for name in (
    "sparse_agg", "topk_select", "distill_kl", "flash_attention")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are compiled from source at first use"
    )


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every named source that has no library yet, one ``nvcc``
    per source, all started together; returns ``{name: library path}``."""
    names = list(SOURCES) if names is None else list(names)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            out.with_name("nvcc.log").write_text(log)
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def build_log(name: str) -> str:
    """``nvcc``'s output from building ``name`` (empty if it was built
    before logs were kept)."""
    log = _lib_path(name).with_name("nvcc.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LIBS[name]
