"""The host min-cut solver: a C++ FIFO push-relabel with global relabeling
and the gap heuristic (maxflow.cpp), which GrabCut's "native" backend
calls once per iteration.

The source is compiled with the C++ compiler at first use into ``_build/``
inside the package (git-ignored), under a file name carrying the source's
hash, and loaded through ``ctypes``.  A failed build raises: nothing falls
back to the device solver.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "maxflow.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: dict[Path, ctypes.CDLL] = {}


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"libmaxflow-{digest[:12]}.so"


def load() -> ctypes.CDLL:
    """The loaded solver library, compiling it first if it is not built.
    Raises RuntimeError, with the compiler's output, when it cannot be
    built."""
    path = _lib_path()
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not path.exists():
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(f"C++ compiler {CXX!r} not found; the native "
                               "min-cut solver cannot build")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed on {SOURCE.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.grid_mincut.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.grid_mincut.restype = None
    _loaded[path] = lib
    return lib


def native_available() -> bool:
    """Whether the solver builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def grid_mincut_native(excess: np.ndarray, caps: tuple,
                       connectivity: int = 8) -> np.ndarray:
    """Solve the lattice min-cut on the host: (H, W) float32 signed excess
    and one (H, W) capacity per direction of ops.maxflow.OFFSETS_8 (the
    first two for 4-connectivity) -> (H, W) bool, True on the source (FG)
    side."""
    lib = load()
    H, W = excess.shape
    ndir = 4 if connectivity == 8 else 2
    caps_arr = np.ascontiguousarray(
        np.stack([np.asarray(c, np.float32) for c in caps[:ndir]]))
    if caps_arr.shape != (ndir, H, W):
        raise ValueError(f"need {ndir} capacity planes of {(H, W)}, got "
                         f"{caps_arr.shape}")
    excess = np.ascontiguousarray(excess, np.float32)
    out = np.zeros(H * W, np.uint8)
    lib.grid_mincut(H, W, connectivity, excess.reshape(-1),
                    caps_arr.reshape(-1), out)
    return out.reshape(H, W).astype(bool)
