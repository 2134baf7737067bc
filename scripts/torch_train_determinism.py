"""Whether a YOLOv8n training step of the PyTorch port repeats bit for bit
on the card, which part breaks it, what the remedy costs, and how far the
card's loss and gradients lie from the CPU's at the training shape.

    python3 scripts/torch_train_determinism.py [--train]

On chip_smoke.py's train_detector setup (yolov8.init_params of seed 0,
input 256, a batch of 16: the phase's held-out pool, seed 991):

  repeat  detection_loss + backward three times from the same
          initialisation and batch under each mode (default; cuDNN
          deterministic; torch.use_deterministic_algorithms): the leaves
          whose gradient differs from the first run's and the largest
          relative difference (norm of the difference over the norm);
  split   in the default mode, the loss's backward alone (the heads'
          outputs as leaves) and the network's alone (the loss's cotangent
          fixed), each twice;
  speed   ms a train_step (median of 30 after 5 warm-up steps, each
          synchronised), the default mode against cuDNN deterministic,
          in the order A B A B;
  cpu     the loss and each leaf's gradient on the CPU against each card
          mode's first run: the loss's relative difference, the worst and
          the median leaf; also at 4 images of 128 (pool seed 1);
  train   (--train) semantic/train.train at chip_smoke.py's settings (pool
          128, 200 steps) twice in each of the default and cuDNN
          deterministic modes: last loss and the held-out evaluate.

Prints the card's name and power limit, then one JSON line a part.
Imports nothing of JAX or of the JAX package.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS is deterministic under use_deterministic_algorithms only with a
# fixed workspace, set before the card is first touched
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dynamic_visual_slam_tpu_torch.models import yolov8  # noqa: E402
from dynamic_visual_slam_tpu_torch.semantic import train  # noqa: E402

SIZE, BATCH = 256, 16
WARMUP, TIMED = 5, 30


@contextlib.contextmanager
def algorithms_deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


MODES = {
    "default": contextlib.nullcontext,
    "cudnn_deterministic": lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False),
    "deterministic_algorithms": algorithms_deterministic,
}


def emit(part, **kw):
    print(json.dumps(dict(part=part, **kw)), flush=True)


def grads_once(init, batch, size, dev):
    model = train.trainable_model(init, dev)
    loss, _ = train.detection_loss(model, *(t.to(dev) for t in batch), size)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu().clone()
                                  for n, p in model.named_parameters()}


def rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def differ(a, b):
    """(leaves not bit-equal, largest relative difference) of two dicts."""
    n = sum(not torch.equal(a[k], b[k]) for k in b)
    return n, max(rel(a[k], b[k]) for k in b)


def against_cpu(card, cpu):
    (lc, gc), (lp, gp) = card, cpu
    r = {k: rel(gc[k], g) for k, g in gp.items()}
    worst = max(r, key=r.get)
    return dict(loss_rel=abs(lc - lp) / abs(lp), worst_leaf=worst,
                worst=r[worst], median=statistics.median(r.values()),
                leaves=len(r))


def part_repeat(init, batch):
    first = {}
    for mode, ctx in MODES.items():
        runs, error = [], None
        try:
            with ctx():
                for _ in range(3):
                    runs.append(grads_once(init, batch, SIZE, "cuda"))
                    torch.cuda.synchronize()
        except RuntimeError as e:
            error = str(e)[:600]
        rows = [differ(g, runs[0][1]) for _, g in runs[1:]]
        emit("repeat", mode=mode, runs=len(runs), error=error,
             losses=[x for x, _ in runs],
             leaves=len(runs[0][1]) if runs else None,
             leaves_differing=[n for n, _ in rows],
             max_rel_diff=[d for _, d in rows])
        if runs:
            first[mode] = runs[0]
    return first


def part_split(init, batch):
    imgs, boxes, mask = (t.cuda() for t in batch)
    model = train.trainable_model(init, "cuda")
    with torch.no_grad():
        outs = model(imgs.permute(0, 3, 1, 2))
    cot = []
    for _ in range(2):
        leaves = [(b.clone().requires_grad_(), c.clone().requires_grad_())
                  for b, c in outs]
        loss, _ = train.detection_loss(lambda x: leaves, imgs, boxes, mask,
                                       SIZE)
        loss.backward()
        cot.append([t.grad.detach().clone() for pair in leaves
                    for t in pair])
    loss_equal = all(torch.equal(a, b) for a, b in zip(*cot))
    nets = []
    for _ in range(2):
        for p in model.parameters():
            p.grad = None
        out = [t for pair in model(imgs.permute(0, 3, 1, 2)) for t in pair]
        torch.autograd.backward(out, cot[0])
        nets.append({n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()})
    n, d = differ(nets[1], nets[0])
    emit("split", loss_backward_equal=loss_equal,
         network_backward_leaves_differing=n, network_max_rel_diff=d)


def part_speed(init, pool):
    imgs, boxes, mask = (t.cuda() for t in pool)
    rng = np.random.default_rng(1)
    out = {}
    for mode in ("default", "cudnn_deterministic") * 2:
        model = train.trainable_model(init, "cuda")
        opt = train.OptaxAdamW(model.parameters(), 1e-3, 200)
        times = []
        with MODES[mode]():
            for it in range(WARMUP + TIMED):
                t0 = time.perf_counter()
                idx = torch.from_numpy(rng.integers(0, len(imgs),
                                                    BATCH)).cuda()
                train.train_step(model, opt, imgs[idx], boxes[idx], mask[idx],
                                 SIZE)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        out.setdefault(mode, []).append(statistics.median(times[WARMUP:]))
    emit("speed", ms_per_step_median=out, steps=TIMED, warmup=WARMUP)


def part_cpu(init, batch, first):
    cpu = grads_once(init, batch, SIZE, "cpu")
    for mode, card in first.items():
        emit("cpu", shape=[BATCH, SIZE], mode=mode,
             **against_cpu(card, cpu))
    small = [torch.from_numpy(a) for a in train.render_pool(4, 128, seed=1)]
    emit("cpu", shape=[4, 128], mode="default",
         **against_cpu(grads_once(init, small, 128, "cuda"),
                       grads_once(init, small, 128, "cpu")))


def part_train(init, held_out):
    for mode in ("default", "cudnn_deterministic"):
        for rep in range(2):
            t0 = time.perf_counter()
            with MODES[mode]():
                params, history = train.train(
                    steps=200, batch=BATCH, input_size=SIZE, pool_images=128,
                    lr=1e-3, seed=0, params=init, log_every=20,
                    verbose=False, device="cuda")
            ev = train.evaluate_pool(params, *held_out, device="cuda")
            emit("train", mode=mode, rep=rep, loss_last=history[-1],
                 history=history, evaluate=ev,
                 seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    init = yolov8.init_params(torch.Generator().manual_seed(0))
    held_out = train.render_pool(BATCH, SIZE, seed=991)
    batch = [torch.from_numpy(a) for a in held_out]
    first = part_repeat(init, batch)
    part_split(init, batch)
    part_speed(init, batch)
    part_cpu(init, batch, first)
    if args.train:
        part_train(init, held_out)


if __name__ == "__main__":
    main()
