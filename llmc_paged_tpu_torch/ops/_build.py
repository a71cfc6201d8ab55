"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc, at its first use, into a
shared library with a plain C interface that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so

The library lands in ``build/torch_kernels/`` beside the package (the
repository's ``build/`` is ignored by git) and is named by a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build from source at first use")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is current. Writes to
    a temporary file and renames, so concurrent builds never load a
    half-written library. Returns the library path."""
    out = library_path(name)
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.monotonic() - t0
    return out


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Build several sources in parallel (one nvcc each, all started
    together). Returns {name: library path}."""
    results: Dict[str, str] = {}
    errors = []

    def one(n):
        try:
            results[n] = build(n)
        except Exception as e:   # collected and re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``fn`` of ``csrc/<name>.cu`` with its argument types
    declared (pointers and the stream as c_void_p, so ctypes never cuts
    them to 32 bits) and an int result: cudaGetLastError() after the
    launch."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return f


def check_operand(name, t, dtypes, shape, device) -> None:
    """Raise unless tensor ``t`` is on ``device``, of one of ``dtypes``,
    of ``shape`` and contiguous: what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(f, device, args, what: str) -> None:
    """Call C entry ``f`` with ``args`` and the current stream of
    ``device``; raise if it returns a CUDA error (a refused launch never
    runs, and no later synchronize reports it)."""
    import torch
    with torch.cuda.device(device):
        rc = f(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
