"""Read the numbers that decide ``correct`` over many seeds in one process,
and the control's beside them, to set the limits in ``checks/<cell>.json``.

    python3 benchmark/calibrate.py --workload <name> --seconds <s>
        --seeds <n> [<n> ...] [--control <k>] [--out <file.jsonl>]

Each seed is one whole run of the cell (render, warm up, the window,
the comparison) at the cell's own sizes; the first ``--control`` seeds also
read the control: the reference computed one precision lower (TF32 in the
float32 stages, float8 in the bf16 detector) in the port's place.  One
JSON line a seed: ``seed``, ``correct``, ``check`` (each number beside its
limit), ``control`` (the control's numbers, where read).  The benchmark's
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def _finite(d):
    return {k: (v if math.isfinite(v) else "inf") for k, v in d.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchlib import cell as cell_mod
    from benchlib import spec
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        for i, seed in enumerate(args.seeds):
            t0 = time.time()
            try:
                res = cell_mod.run(cell, seed, args.seconds, False,
                                   torch.device("cuda", 0), t0,
                                   control=i < args.control)
            except Exception:       # a seed that fails is a reading too
                print(json.dumps({"seed": seed,
                                  "error": traceback.format_exc()}),
                      file=out, flush=True)
                continue
            line = {"seed": seed, "correct": res["correct"],
                    "failed": res["failed"], "metrics": res["metrics"],
                    "check": {k: v["value"] for k, v in
                              res["check"].items()},
                    "seconds": time.time() - t0}
            line["check"] = _finite(line["check"])
            if "control" in res:
                line["control"] = _finite(res["control"])
            print(json.dumps(line), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
