"""Out-of-distribution detector efficacy on the port: the counterpart of
the reference's ``scripts/ood_eval.py``.

    python scripts/torch_ood_eval.py [n_frames] [weights_path]
        [--device cuda|cpu]

The shipped YOLOv8n (``assets/yolov8n_synth.npz``) in the SLAM loop
(``semantic/train.in_loop_eval``: culling off, ground-truth boxes, the
learned detector) on the default walkers, then on
``synthetic.hard_walkers(n_frames)``: approach and recede, stop-and-go,
mutual occlusion, which the training family does not generate.  Prints
the reference's JSON, ``in_distribution`` and ``out_of_distribution``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.models.convert_ultralytics import \
    load_params
from dynamic_visual_slam_tpu_torch.pipeline.slam import resolve_device
from dynamic_visual_slam_tpu_torch.semantic import train

WEIGHTS = Path(__file__).resolve().parents[2] / "assets" / \
    "yolov8n_synth.npz"


def evaluate(params, n_frames: int, device) -> Dict:
    """The two in-loop evaluations, as the reference's script runs them."""
    print("== in-distribution (default_walkers) ==", flush=True)
    res_id = train.in_loop_eval(params, n_frames=n_frames, seed=0,
                                device=device)
    print("== OUT-of-distribution (hard_walkers) ==", flush=True)
    res_ood = train.in_loop_eval(params, n_frames=n_frames, seed=0,
                                 objects=synthetic.hard_walkers(n_frames),
                                 device=device)
    return dict(in_distribution=res_id, out_of_distribution=res_ood)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="torch_ood_eval")
    ap.add_argument("n_frames", type=int, nargs="?", default=180)
    ap.add_argument("weights", nargs="?", default=str(WEIGHTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = load_params(args.weights)
    print(f"weights: {args.weights}", flush=True)
    print(json.dumps(evaluate(params, args.n_frames, dev), indent=2))
    return 0
