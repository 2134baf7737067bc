"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell, its configuration, traffic mix, limits and per-layer metrics are
found by name from ``BENCHMARK.json`` (``benchlib.spec``).  The run needs as
many CUDA devices as the cell asks for and never falls back to the CPU: it
exits 2 without them, before printing any result.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``
(frames), ``metrics`` (the cell's end-to-end metrics; per-layer ones with
``--trace 1``), ``device``, ``breakdown`` (traced runs) and ``check``, each
number compared with the reference beside its limit; those numbers are
also the last lines on standard error.  The run exits 3, with no result,
if the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache of the run at a fixed path inside the checkout
CACHE = ROOT / "build" / "benchmark"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "dynamic_visual_slam_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchlib import cell as cell_mod
    from benchlib import spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}, power limit "
          f"{cell_mod.power_limit()}", file=sys.stderr)
    res = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"run: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, j in res["check"].items():
        if not math.isfinite(j["value"]):
            j["value"] = "inf"      # a number the run could not read
        print(f"check {name}: {j['value']!r} (limit {j['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
