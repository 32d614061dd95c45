"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, which ``ctypes`` loads.
Builds happen at first use, into ``_build/`` inside the package (git-ignored),
under a file name carrying the source's hash: an edited source rebuilds, an
unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/ (without the .cu suffix)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together.  Raises with nvcc's output
    if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: _lib_path(n) for n in names}
    procs = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
