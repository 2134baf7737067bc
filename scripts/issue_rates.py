"""Instruction issue rates of one GPU, and the SASS instruction mix of the
port's kernels: the inputs of kernel B1's bound in chip_smoke.py.

    python3 scripts/issue_rates.py

Builds scripts/issue_rates.cu (a probe: long independent chains of one
instruction class, 8 blocks of 256 threads an SM) and the port's kernels
with the port's nvcc flags, then prints one JSON line each:

  device  the card's name and nvidia-smi name/power limit;
  rates   instructions a second (one lane's instruction counted once) of
          min.f32, add.f32, min.s16x2, lop3.b32 and the three-input DPX
          __vimin3_s16x2 / __vimax3_s16x2: the median of 7 CUDA-event
          timings of one launch (chip_smoke.cuda_ms);
  sass    for each kernel function of the probe and of the port's
          libraries, its instructions by SASS opcode (``cuobjdump -sass``),
          so that the probe's chains and B1's min/max can be checked to be
          the instructions they are counted as.

chip_smoke.py's ``ISSUE_RATES`` holds the rates of one run (PERF.md names
it).  Needs a card and the CUDA toolkit.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms, emit, phase_device  # noqa: E402
from dynamic_visual_slam_tpu_torch import kernels  # noqa: E402

PROBE = Path(__file__).resolve().parent / "issue_rates.cu"
OPS = ("fmin", "fadd", "min_s16x2", "int32", "min3_s16x2", "max3_s16x2")
ITERS = 2048
PER_ITER = 128          # instructions a thread an iteration (16 x 8 chains)


def build_probe() -> Path:
    out = kernels.BUILD_DIR / "libissue_rates.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(PROBE)], check=True)
    return out


def rates(lib: Path) -> dict:
    fn = ctypes.CDLL(str(lib)).issue_rate_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n = blocks * 256 * ITERS * PER_ITER
    got = {}
    for op, name in enumerate(OPS):
        def run():
            kernels.check("issue_rate_probe",
                          fn(op, blocks, ITERS, out.data_ptr(), stream))
        got[name] = n / (cuda_ms(run) * 1e-3)
    return got


def sass_mix(lib: Path) -> dict:
    """{function: {opcode: count}} of a built library."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.x]*)",
                     line)
        if m and fn is not None:
            mix[fn][m.group(1)] += 1
    return {f: dict(c.most_common()) for f, c in mix.items()}


def main() -> None:
    phase_device()
    probe = build_probe()
    kernels.build()
    emit("rates", rates=rates(probe), iters=ITERS, per_iter=PER_ITER)
    libs = [probe] + [kernels.library_path(n) for n in kernels.SOURCES]
    for lib in libs:
        emit("sass", library=lib.name, functions=sass_mix(lib))


if __name__ == "__main__":
    main()
