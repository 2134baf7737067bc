"""Build the port's native runtime (``runtime.cpp``) with g++ (no external
deps), at first use, into ``build/native/`` at the repository root.

    python -m dynamic_visual_slam_tpu_torch.native.build

The library's name carries a digest of the source and the flags, so an
edited source is rebuilt rather than reused.  Each build compiles to a name
of its own and ``os.replace``-s the result into place: processes that build
at once (test workers) each leave a whole library, and none loads a
half-written one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdvsruntime-{digest}.so"


def build(verbose: bool = True) -> str:
    """Compile the library; raises RuntimeError with the compiler's output
    (or the reason it could not start) on failure."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def ensure_built() -> str:
    """Build if missing; returns the .so path."""
    out = library_path()
    if not out.exists():
        build(verbose=False)
    return str(out)


if __name__ == "__main__":
    print(build())
