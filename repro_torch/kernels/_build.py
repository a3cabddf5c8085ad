"""Build, load and check the inputs of the hand-written CUDA kernels.

Each kernel package holds its sources under ``csrc/*.cu``, written against
a plain C interface.  On first use they are compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``build/kernels/`` at the root of the checkout and
loaded with ``ctypes``.  The library's file name carries a hash of its
source, so an edited source is rebuilt and a stale library is never loaded.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises if that is not 0.
Nothing here runs at import time: this module is imported on machines that
have no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")          # ptxas prints registers and spills

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def sources(name: str) -> list[Path]:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources for kernel {name!r}")
    return srcs


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for kernel {name!r}:\n{log}")
    os.replace(tmp, out)              # atomic: readers see all or nothing
    return log


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all at once (one
    nvcc process per kernel, started together).  Returns nvcc's output
    (ptxas register and spill counts) for each kernel it built."""
    jobs = {n: _start_build(n) for n in names}
    logs, errors = {}, []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            logs[n] = _finish_build(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def all_kernels() -> list[str]:
    return sorted(p.parent.parent.name
                  for p in KERNELS_DIR.glob("*/csrc/*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def check_inputs(name: str, floats, ints, *, shapes_ok: bool,
                 head_dim: int) -> None:
    """Raise unless the tensors are what the kernel takes: one CUDA device,
    contiguous, float tensors of one supported dtype, int32 index tensors,
    consistent shapes."""
    dev = floats[0].device
    dtype = floats[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel needs CUDA "
                         "tensors (CPU tensors take the plain version)")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported; "
                         f"expected one of {list(DTYPE_CODES)}")
    for t in (*floats, *ints):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.dtype != dtype for t in floats):
        raise ValueError(f"{name}: q, k and v must share one dtype")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: positions must be int32")
    if not shapes_ok:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{[tuple(t.shape) for t in (*floats, *ints)]}")
    if not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {head_dim} outside "
                         f"1..{MAX_HEAD_DIM}")
