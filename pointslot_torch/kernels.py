"""Build and load the port's hand-written CUDA kernels and host helpers.

Each ``csrc/<name>.cu`` exports a plain C entry point and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/kernels/`` at
the repository root, named by a hash of the source and the flags, so a
changed source builds anew and an unchanged one is reused. Builds happen at
first use on the machine with the card; ``build()`` starts one ``nvcc`` per
missing source, all at once.

Host helpers (``csrc/<name>.c``, the PNG unfilter) are built the same way
by the host C compiler (``cc``, which ``nvcc`` needs too) into
``build/host/`` at first use, on any machine, by ``load_host``. A failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("patch_gather",)
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
CC_FLAGS = ("-O3", "-std=c11", "-shared", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every listed kernel whose library is missing, in parallel.
    Returns {name: seconds} for the kernels built by this call; raises with
    the compiler's output if any build fails."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(n))
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def host_library_path(name: str) -> Path:
    src = (CSRC / f"{name}.c").read_bytes()
    digest = hashlib.sha256(src + " ".join(CC_FLAGS).encode()).hexdigest()
    return HOST_BUILD_DIR / f"{name}-{digest[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host helper `name` (``csrc/<name>.c``), compiled by the
    host C compiler first if its library is missing. Safe to call from
    several threads at once."""
    with _HOST_LOCK:
        key = f"host:{name}"
        if key not in _LOADED:
            path = host_library_path(name)
            if not path.exists():
                cc = shutil.which("cc") or shutil.which("gcc")
                if cc is None:
                    raise RuntimeError(f"no C compiler (cc or gcc) on PATH to build {name}.c")
                HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.c")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cc} failed for {name}.c (rc {proc.returncode}):\n"
                                       f"{proc.stdout}")
                os.replace(tmp, path)
            _LOADED[key] = ctypes.CDLL(str(path))
        return _LOADED[key]
