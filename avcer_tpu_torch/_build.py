"""Build the package's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it into a shared library in seconds (the two fused
convolution kernels, templates over a shared header, in about a minute). Libraries go to
``build/avcer_tpu_torch/`` at the root of the checkout, named by a hash of the
source and the flags: an edited source rebuilds, an unchanged one loads the
existing library. A failed build raises with the compiler's output; nothing
falls back. Every build targets Hopper (``sm_90a``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "avcer_tpu_torch"
KERNELS = ("nms", "attention", "fused_resnet", "fused_ssh")
#: headers under csrc/ that a kernel's source includes: part of its hash
HEADERS = {"attention": ("mma.cuh",), "fused_resnet": ("conv_tile.cuh", "mma.cuh"),
           "fused_ssh": ("conv_tile.cuh", "mma.cuh")}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the NMS keep set must match the JAX reference bit for bit: no contraction
#: of a multiply and an add into an FMA anywhere in that file. (The fused
#: convolution kernels keep their FMAs in the products and use rounding
#: intrinsics where a multiply and an add must stay apart.)
_EXTRA_FLAGS = {"nms": ("--fmad=false",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where the built library for kernel ``name`` lives (it may not exist
    yet)."""
    flags = _FLAGS + _EXTRA_FLAGS.get(name, ())
    src = b"".join((CSRC / f).read_bytes()
                   for f in (f"{name}.cu", *HEADERS.get(name, ())))
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *_FLAGS, *_EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # ptxas -v: registers, shared memory and spills per kernel
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _libs[name] = lib
        return lib


def build_all() -> dict[str, float]:
    """Build every kernel, one nvcc per source and all at once, then load
    them; returns the seconds each build took."""
    took: dict[str, float] = {}

    def timed(name: str) -> None:
        t0 = time.perf_counter()
        _compile(name)
        took[name] = time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for job in [pool.submit(timed, name) for name in KERNELS]:
            job.result()  # a failed build raises here
    for name in KERNELS:
        library(name)
    return {name: took[name] for name in KERNELS}


def ptxas_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""
