"""Build the port's CUDA sources into shared libraries and load them.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/lib<name>-<digest>.so`` at the repository
root (the digest covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source never loads a stale library) and bound through ``ctypes``: every source exposes a
plain C interface, so no PyTorch header is compiled. Nothing here runs when
the package is imported; the first launch of a kernel builds its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "library", "bind",
           "build_all", "build_log", "find_nvcc"]

# every csrc/<name>.cu of the port
SOURCES = ("acam_attention", "acam_attention_single", "acam_lut", "acam_mvm",
           "acam_prolog", "acam_softmax")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math, and no contraction of a multiply and an add into an
# FMA that the reference does not do (the kernels spell out every f32 step)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built from source")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = hashlib.sha256(h.digest() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (registers, shared memory, spills)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names) -> None:
    """Build the libraries of ``names`` that are not built yet, one ``nvcc``
    process per source, all started together."""
    todo = [n for n in names if not _target(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{out.name} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed building " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        out = _target(name)
        if not out.exists():
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def bind(lib_name: str, fn_name: str, argtypes):
    """The C function ``fn_name`` of ``csrc/<lib_name>.cu``, its argument
    types set and its result the CUDA error code (an int)."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
