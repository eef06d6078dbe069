"""Build the package's native code and load it with ctypes.

Each CUDA source in ``scope_tpu_torch/csrc/`` compiles with nvcc, and the
host C++ source of the serving engine's slot scheduler
(``scope_tpu_torch/native/scheduler.cpp``) with the host C++ compiler, on
its own into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds).  Libraries land in
``scope_tpu_torch/_build/``, named by a hash of every source, header and
flag, and are built at first use; ``build()`` compiles all of them at once,
one compiler per source started together.  A missing compiler or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("flash_prefill.cu", "colsum_scores.cu")
HOST_SOURCES = ("scheduler.cpp",)
SOURCES = KERNEL_SOURCES + HOST_SOURCES
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS).encode())
    # .cu sources and .cuh headers, and the host sources.
    for f in sorted([*CSRC.glob("*.cu*"), *NATIVE.glob("*.cpp")]):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest()}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build scope_tpu_torch's kernels")
    return nvcc


def _cxx() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found: it is "
                           "needed to build scope_tpu_torch's slot scheduler")
    return cxx


def _command(source: str, out: Path) -> list:
    if source in HOST_SOURCES:
        return [_cxx(), *CXX_FLAGS, "-o", str(out), str(NATIVE / source)]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / source)]


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns the compiler's log (register and shared-memory use from
    ``-Xptxas -v`` for the kernels) for each source it built."""
    todo = [s for s in sources if not lib_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in todo:
        tmp = lib_path(s).with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (tmp, subprocess.Popen(_command(s, tmp),
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    logs, failed = {}, []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[s] = out
        if proc.returncode != 0:
            failed.append(f"building {s} failed (exit {proc.returncode}):\n"
                          f"{out}")
        else:
            os.replace(tmp, lib_path(s))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        if not lib_path(source).exists():
            build([source])
        lib = ctypes.CDLL(str(lib_path(source)))
        if source in KERNEL_SOURCES:
            lib.scope_error_string.argtypes = [ctypes.c_int]
            lib.scope_error_string.restype = ctypes.c_char_p
        _loaded[source] = lib
    return lib


def sass(source: str) -> str:
    """The SASS of one source's library (``cuobjdump -sass``, from nvcc's
    toolkit), built first if needed."""
    if not lib_path(source).exists():
        build([source])
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def check(source: str, err: int) -> None:
    """Raise if a launch from ``source``'s library returned a CUDA error."""
    if err != 0:
        msg = load(source).scope_error_string(err).decode()
        raise RuntimeError(f"{Path(source).stem} kernel failed to launch: "
                           f"CUDA error {err} ({msg})")
