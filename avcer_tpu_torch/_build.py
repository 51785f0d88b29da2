"""Build the package's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it into a shared library in seconds (the two fused
convolution kernels, templates over a shared header, in minutes). Libraries go to
the build directory (below), named by a hash of the source, the flags and the toolkit (``nvcc --version``): an edited source or
another toolkit rebuilds, an unchanged one loads the existing library. A
failed build raises with the compiler's output; nothing falls back. Every
build targets Hopper (``sm_90a``).

The library directory is the port's counterpart of the JAX package's
persistent compile cache (avcer_tpu/core/tpuenv.py), so that a serving fleet
restarts warm. It comes from, in this order: ``set_cache_dir`` (``cli.run
--compile_cache_dir DIR``, called before any model is built), the
``AVCER_COMPILE_CACHE`` environment variable, and ``build/avcer_tpu_torch/``
at the root of the checkout. The JAX package's disabling values ("", 0, off,
none, disabled) give a fresh temporary directory, removed at exit: every
kernel then builds anew, as JAX compiles anew without its cache.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from avcer_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "avcer_tpu_torch"
CACHE_ENV = "AVCER_COMPILE_CACHE"
#: the JAX package's values that turn the cache off (tpuenv.py), and ""
DISABLE_TOKENS = ("", "0", "off", "none", "disabled")
KERNELS = ("nms", "attention", "fused_resnet", "fused_ssh", "image")
#: headers under csrc/ that a kernel's source includes: part of its hash
HEADERS = {"attention": ("mma.cuh",), "fused_resnet": ("conv_tile.cuh", "mma.cuh"),
           "fused_ssh": ("conv_tile.cuh", "mma.cuh")}
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the NMS keep set must match the JAX reference bit for bit: no contraction
#: of a multiply and an add into an FMA anywhere in that file. (The fused
#: convolution kernels keep their FMAs in the products and use rounding
#: intrinsics where a multiply and an add must stay apart.) The I420 rebuild
#: must equal its plain version bit for bit: the same flag. The two fused
#: convolution sources, each some ten kernel instantiations, optimise their
#: functions on four threads apiece (the two build at once on eight cores):
#: 190-200 s -> 93 s on the H100's host, the same registers and spills.
_EXTRA_FLAGS = {"nms": ("--fmad=false",), "image": ("--fmad=false",),
                "fused_resnet": ("-split-compile=4",), "fused_ssh": ("-split-compile=4",)}

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
_build_dir: Path | None = None
#: nvcc builds this process ran (a warm cache runs none)
compiles = 0


def _resolve(path: str) -> Path:
    if path.strip().lower() in DISABLE_TOKENS:
        tmp = tempfile.mkdtemp(prefix="avcer_tpu_torch_build_")
        atexit.register(shutil.rmtree, tmp, ignore_errors=True)
        return Path(tmp)
    return Path(path).expanduser()


def set_cache_dir(path: str | None) -> Path:
    """Take the kernel libraries from ``path`` (None: the environment or the
    default, see the module docstring); a disabling value gives a fresh
    temporary directory. Libraries loaded already stay loaded. Returns the
    directory."""
    global _build_dir
    with _lock:
        _build_dir = None if path is None else _resolve(path)
    return build_dir()


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from."""
    global _build_dir
    with _lock:
        if _build_dir is None:
            env = os.environ.get(CACHE_ENV)
            _build_dir = DEFAULT_BUILD_DIR if env is None else _resolve(env)
        return _build_dir


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


@functools.cache
def toolkit() -> str:
    """``nvcc --version``: part of every library's hash, so that a directory
    shared between machines never loads a library another toolkit built."""
    return subprocess.run([nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip()


def library_path(name: str) -> Path:
    """Where the built library for kernel ``name`` lives (it may not exist
    yet)."""
    flags = _FLAGS + _EXTRA_FLAGS.get(name, ())
    src = b"".join((CSRC / f).read_bytes()
                   for f in (f"{name}.cu", *HEADERS.get(name, ())))
    key = src + " ".join(flags).encode() + toolkit().encode()
    return build_dir() / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    global compiles
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
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
    with _lock:
        compiles += 1
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed (the
    span ``setup.kernel_load``, ``compiled`` if nvcc ran)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            before = compiles
            with trace.setup("kernel_load", kernel=name) as sp:
                lib = ctypes.CDLL(str(_compile(name)))
                sp.note(compiled=compiles > before)
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
