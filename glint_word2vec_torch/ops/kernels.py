"""Build and bind the port's CUDA kernels (``glint_word2vec_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded through ctypes. The library is built at first use, into
``glint_word2vec_torch/_build/`` (ignored by git), under a name keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is reused.
Delete the directory to force a rebuild. Nothing here runs at import time: this module
is imported on machines without nvcc, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from glint_word2vec_torch.lockcheck import make_lock

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = make_lock("ops.kernels.build")
_libs: Dict[str, ctypes.CDLL] = {}

# C signatures of the exported functions, per source.
_SIGNATURES = {
    "sgns_shared": {
        "glint_sgns_scratch_floats": (ctypes.c_int64, [ctypes.c_int] * 3),
        "glint_sgns_shared_step": (
            ctypes.c_int,
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p]),
    },
    "scatter_rows": {
        "glint_scatter_rows": (
            ctypes.c_int,
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 6),
        "glint_scatter_scratch_bytes": (ctypes.c_int64, [ctypes.c_int64]),
        "glint_scatter_prepare": (ctypes.c_int, []),
        "glint_scatter_flag_create": (ctypes.c_void_p, []),
        "glint_scatter_flag_device": (ctypes.c_void_p, [ctypes.c_void_p]),
    },
    # scatterprobe.py --variants: not a kernel of the port, built only by that probe
    "probes/scatter_bound": {
        "glint_scatter_probe": (
            ctypes.c_int,
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                                      ctypes.c_void_p]),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else /usr/local/cuda, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                           "glint_word2vec_torch are built from source at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name.replace('/', '_')}-{key}.so"


def build_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


class PendingBuild(NamedTuple):
    name: str
    proc: subprocess.Popen
    tmp: Path      # nvcc writes here; renamed into place once it succeeds
    log: Path      # nvcc's output


def start_build(name: str) -> Optional[PendingBuild]:
    """Start compiling ``csrc/<name>.cu`` unless its library exists; returns the
    running build, or None when nothing needs building. :func:`load` waits for it,
    so several sources can compile at once."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp-{os.getpid()}.so")
    log = out.with_suffix(".log")
    with open(log, "wb") as f:
        proc = subprocess.Popen(build_command(name, tmp), stdout=f,
                                stderr=subprocess.STDOUT)
    return PendingBuild(name, proc, tmp, log)


def _finish_build(build: PendingBuild) -> None:
    rc = build.proc.wait()
    if rc != 0:
        text = build.log.read_text(errors="replace")
        raise RuntimeError(f"nvcc failed building {build.name}.cu (exit {rc}):\n{text}")
    os.replace(build.tmp, library_path(build.name))


def load(name: str, build: Optional[PendingBuild] = None) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed (pass the
    build from :func:`start_build` to wait for one already running)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if build is None:
            build = start_build(name)
        if build is not None:
            _finish_build(build)
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _libs[name] = lib
        return lib


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/`` (not its ``probes/``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
