"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
alone into its own shared library (no PyTorch headers, so a build takes
seconds), at first use, into ``build/kernels/`` at the repository root.
The libraries are loaded with ``ctypes``; every pointer and the stream are
passed as ``c_void_p``.  Library names carry a digest of the source and the
flags, so an edited source is rebuilt rather than reused.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, no
``--use_fast_math``, and ``-fmad=false``: a contracted multiply-add rounds
once where the plain PyTorch versions round twice, which would flip the
``rint`` of a rotated BRIEF offset.

``launches`` counts, per kernel, the launches made by the wrappers in
``ops/fields.py`` and ``ops/descriptors.py``; ``chip_smoke.py`` resets it
before it drives the main path and reads it after.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = {
    "fast_score": "fast_score.cu",
    "orb_desc_moments": "orb_desc_moments.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
ARGTYPES = {
    "fast_score_levels": [_P, _P, _P, _P, _I, _I, _P],
    "orb_desc_moments": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                         _P, _P, _P],
}
ENTRY = {"fast_score": "fast_score_levels",
         "orb_desc_moments": "orb_desc_moments"}

launches: collections.Counter = collections.Counter()
_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    launches.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  → seconds per kernel built
    (wall time of its nvcc process).  Raises with nvcc's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT),
                    tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for n, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return seconds


def entry(name: str):
    """The C entry point of kernel ``name`` (building it if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, ENTRY[name])
        fn.argtypes = ARGTYPES[ENTRY[name]]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(lib, ENTRY[name])


def check(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def pointer_array(values) -> ctypes.Array:
    """Host array of device pointers (Python ints) for a C entry point; the
    caller keeps it alive across the call."""
    return (ctypes.c_void_p * len(values))(*values)


def int_array(values) -> ctypes.Array:
    """Host array of C ints for a C entry point."""
    return (ctypes.c_int * len(values))(*[int(v) for v in values])
