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
``ops/fields.py``, ``ops/descriptors.py``, ``ops/detect.py`` and
``frontend/ransac.py`` (through ``count``, once a call, under a
lock: the fleet's shards launch from one thread each); ``chip_smoke.py``
resets it before it drives the main path and reads it after.  ``entry``
builds and loads under a lock too, so threads that reach an unbuilt kernel
together run one ``nvcc``; the first unbuilt kernel a process reaches
builds every unbuilt one, their ``nvcc`` processes side by side, so the
set-up of a run pays for the slowest build, not for their sum.

The kernels (each source's header note has the detail):

- ``fast_score.cu`` (B1, and B3 on one level): replaces the reference's
  ``ops/fields.py::_score_atlas_rows`` and ``ops/fast.py::corner_score_pallas``.
  Bound by its min/max instructions, which run at half the f32 add rate.
  A persistent grid stages 64x32 tiles with cheap index arithmetic. Where a
  tile's pixels are all bytes, as on every level of the main path, it scores
  two pixels with each three-input 16-bit DPX min/max. Otherwise it uses
  f32 min/max.
- ``orb_desc_moments.cu`` (B2): replaces
  ``ops/descriptors.py::descriptors_moments_pallas``.  Bound by device memory
  (the disc's raw pixels and the 512 blurred samples of each keypoint).
  Persistent warps keep the sampling pattern in registers. Each lane streams
  one disc column without shared memory, and each lane writes its 8 bits in
  one store.
- ``pnp_ransac.cu``: replaces no Pallas kernel (the reference's
  ``frontend/ransac.py::pnp_ransac`` is plain jnp); it runs the port's
  plain PnP RANSAC, some 4,400 tiny PyTorch launches a call, as one.
  Bound by neither bytes nor operations on this card: its time is the
  chain of dependent steps inside one block a problem (the DLT's squarings
  and pivots, 20 block-wide reductions and 6x6 solves).  One warp solves a
  DLT at a time in shared memory, the scoring keeps points in registers
  and counts inliers by warp ballot, and Gauss-Newton reduces its float64
  normal equations over the block.
- ``orb_detect.cu`` (D1): replaces no Pallas kernel (the reference's
  ``frontend/orb.py::detect_level`` is plain jnp); it runs the port's plain
  detection, some 1,400 tiny PyTorch launches a call at 8 levels, as two:
  a warp a 35-px cell finds the peaks, applies the FAST 20 -> 7 fallback
  and keeps the cell's top 8 packed keys, then a block a (frame, level)
  selects the level's quota by a radix select and ranks it.  Bound by
  device memory (each score read once), far below the host's launch cost
  it removes.
- ``persistent.cuh``: the grid size of a persistent kernel, shared by B1
  and B2.
"""

from __future__ import annotations

import collections
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
SOURCES = {
    "fast_score": "fast_score.cu",
    "orb_desc_moments": "orb_desc_moments.cu",
    "pnp_ransac": "pnp_ransac.cu",
    "orb_detect": "orb_detect.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    "fast_score_levels": [_P, _P, _P, _P, _I, _I, _P],
    "orb_desc_moments": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                         _P, _P, _P],
    "pnp_ransac": [_P] * 13 + [_I] * 5 + [_F] * 7 + [_I, _P],
    "orb_detect": [_P] * 5 + [_I, _I, _F, _F, _I] + [_P] * 8,
}
ENTRY = {"fast_score": "fast_score_levels",
         "orb_desc_moments": "orb_desc_moments",
         "pnp_ransac": "pnp_ransac",
         "orb_detect": "orb_detect"}

launches: collections.Counter = collections.Counter()
_loaded: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_load_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        launches.clear()


def count(name: str) -> None:
    """One launch of kernel ``name``; the wrappers call it where they
    launch, and nowhere else."""
    with _count_lock:
        launches[name] += 1


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
    """The built library of kernel ``name``; its digest covers the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))])
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
    """The C entry point of kernel ``name`` (building, together, every
    kernel not built yet)."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build(SOURCES)
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


def float_array(values) -> ctypes.Array:
    """Host array of C floats (each value rounded to float32) for a C entry
    point."""
    return (ctypes.c_float * len(values))(*[float(v) for v in values])
