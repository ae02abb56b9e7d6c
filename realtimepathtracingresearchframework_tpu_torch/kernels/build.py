"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/kernels/lib<name>-<digest>.so`` at the repository
root (git-ignored); the digest covers the source and the flags, so an
edited source is rebuilt. The target is ``sm_90a`` (Hopper) and the flags
keep IEEE arithmetic: ``--fmad=false`` and no fast math, so no FMA
contraction and no flushing of denormals, which is what lets each kernel
equal its plain PyTorch version bitwise.

There is no fallback: if nvcc is missing or the build fails, ``build``
raises with the compiler's message. ``build_many`` and ``load`` hold one
process-wide lock, so threads (``Renderer.warmup_async`` and the first
frame) build and load each library once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600

_loaded: dict = {}  # name -> ctypes.CDLL, one load per process
_lock = threading.RLock()  # held by build_many and load (load builds)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (default /usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    search = os.pathsep.join(
        [os.environ.get("PATH", ""), os.path.join(cuda_home, "bin")]
    )
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels "
            f"in {CSRC_DIR} are built from source at first use and have no "
            "fallback"
        )
    return nvcc


def library_path(name: str) -> Path:
    """The library's path; its digest covers the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    data = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_many(names, verbose: bool = False) -> list:
    """Compile each ``csrc/<name>.cu`` that is not built yet, one nvcc
    process per source, all started together; returns the library paths.
    ``verbose`` rebuilds, adds ``-Xptxas -v`` and prints the compiler's
    report (registers, shared memory, spills)."""
    with _lock:
        outs = [library_path(name) for name in names]
        todo = [(n, o) for n, o in zip(names, outs) if verbose or not o.exists()]
        if not todo:
            return outs
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            # unique per process and thread: other processes may build the
            # same library into the same directory
            tmp = out.with_name(
                f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu (exit "
                              f"{proc.returncode}):\n{stderr}{stdout}")
                continue
            if verbose:
                print(f"{name}.cu:\n{stderr.strip()}")
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        return outs


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path (see ``build_many``)."""
    return build_many([name], verbose)[0]


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
