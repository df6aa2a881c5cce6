"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/*.cu`` file has a plain C entry point and compiles on its own
(with the shared ``csrc/*.cuh`` headers it includes) into a shared library
for ``sm_90a`` (no PyTorch headers, so a build takes seconds).  All sources
compile in parallel, at first use, into ``build/kernels/<digest>/`` under the
repository root, where the digest is a hash of the sources, headers and
flags, so an edited source rebuilds and an unchanged one loads.  A missing ``nvcc`` or a failed build raises.
A library that also exports ``<name>_load`` has it called once, as it is
loaded, so that its kernels load then and not inside their first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point of each kernel: argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them); every entry returns the
# cudaError_t of its launch
SIGNATURES = {
    "suffix_pack": [_P, _L, _I, _I, _I, _I, _P, _I, _P, _P],
    "hash_partition": [_P, _P, _L, _I, _P, _P, _I, _P],
    "lcp_boundary": [_P, _L, _I, _I, _P, _P, _P],
    "bsearch": [_P, _L, _L, _I, _P, _L, _P, _P, _I, _I, _I, _P, _P],
    "hash_combine": [_P, _L, _P, _L, _L, _I, _I, _P, _L, _I, _P],
    "merge_path": [_P, _P, _P, _P, _L, _L, _I, _I, _P, _P, _P],
    "block_expand": [_P, _L, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P, _L, _L,
                     _I, _P],
    "block_decode": [_P, _L, _P, _L, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                     _P, _P, _P],
}

_ENTRIES: dict[str, ctypes._CFuncPtr] | None = None
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join([nvcc] + NVCC_FLAGS).encode())
    for name in sorted(SIGNATURES):
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by several sources
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every kernel source (in parallel) unless already built.

    Returns the shared library of each kernel; ``build_info`` records the
    wall seconds and each compiler's ``-Xptxas -v`` report.
    """
    nvcc = nvcc_path()
    out_dir = BUILD_ROOT / _digest(nvcc)
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in SIGNATURES}
    t0 = time.perf_counter()
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{reports[name]}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    build_info.update(seconds=time.perf_counter() - t0, compiled=sorted(procs),
                      ptxas=reports, directory=str(out_dir))
    return libs


def entries() -> dict[str, ctypes._CFuncPtr]:
    """The C entry point of every kernel, building the libraries at first use."""
    global _ENTRIES
    if _ENTRIES is None:
        found = {}
        for name, lib in build().items():
            so = ctypes.CDLL(str(lib))
            fn = getattr(so, f"{name}_launch")
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            found[name] = fn
            load = getattr(so, f"{name}_load", None)
            if load is not None and load() != 0:
                raise RuntimeError(f"CUDA kernels of {name} failed to load")
        _ENTRIES = found
    return _ENTRIES
