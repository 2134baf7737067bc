"""Which summation order does the reference's ``gaussian_blur`` use on the
CPU?  Counts, level by level and pass by pass, the outputs of the
reference's jitted banded f32 ``jnp.dot``s (``ops/image.py``, vmapped over
the 4 frames of the seed-11 320x240 fixture, as its ``extract_batch``
calls it) that differ from candidate orders over the 7 nonzero taps:

- ``chain``: one fused multiply-add chain, taps ascending, from 0;
- ``kc<n>``: the chain restarted at every multiple of n of the
  contraction index and the block sums added (Eigen's ``kc`` blocking);
- ``split<u>``: u chains over the taps by index mod u, added in order;
- ``pairwise``: rounded products summed as a tree.

Fused multiply-adds are formed in float64 and rounded once (exact for these
magnitudes).  Also prints ``torch.matmul``'s (the port's blur before this
script) and the rounded blur's counts.  Run on the CPU (slow: pure numpy
loops, about ten minutes):

    JAX_PLATFORMS=cpu python scripts/torch_blur_order.py
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dynamic_visual_slam_tpu.config import CameraConfig, ORBConfig  # noqa: E402
from dynamic_visual_slam_tpu.io import synthetic  # noqa: E402
from dynamic_visual_slam_tpu.ops import image as jim  # noqa: E402

F32 = np.float32


def fma(a, b, c):
    return (np.float64(a) * b.astype(np.float64) + c.astype(np.float64)
            ).astype(F32)


def chain(taps, b, x):
    acc = np.zeros(x.shape[1:], F32)
    for s in taps:
        acc = fma(b[s], x[s], acc)
    return acc


def kblock(kc):
    def order(taps, b, x):
        total = None
        for blk in sorted({s // kc for s in taps}):
            acc = chain([s for s in taps if s // kc == blk], b, x)
            total = acc if total is None else (total + acc).astype(F32)
        return total
    return order


def split(u):
    def order(taps, b, x):
        tot = np.zeros(x.shape[1:], F32)
        for j in range(u):
            tot = (tot + chain([s for s in taps if s % u == j], b, x)
                   ).astype(F32)
        return tot
    return order


def pairwise(taps, b, x):
    ps = [(np.float64(b[s]) * x[s].astype(np.float64)).astype(F32)
          for s in taps]
    while len(ps) > 1:
        ps = [(ps[j] + ps[j + 1]).astype(F32) if j + 1 < len(ps) else ps[j]
              for j in range(0, len(ps), 2)]
    return ps[0]


def contract(band, x, order):
    """out[i] = sum over taps s of band[i, s] * x[s] in ``order``."""
    return np.stack([order(np.nonzero(band[i])[0], band[i], x)
                     for i in range(band.shape[0])])


def main() -> None:
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=159.5, cy=119.5)
    cfg = ORBConfig()
    seq = synthetic.generate_sequence(cam, 4, seed=11, depth_noise=0.004)
    frames = np.stack([g for g, *_ in seq]).astype(F32)
    levels = [np.asarray(lv) for lv in jax.jit(jax.vmap(
        lambda im: jim.build_pyramid(im, cfg.n_levels, cfg.scale_factor)))(
            jnp.asarray(frames))]
    orders = dict(chain=chain, pairwise=pairwise, kc8=kblock(8),
                  kc32=kblock(32), kc128=kblock(128), split2=split(2),
                  split4=split(4), split8=split(8))
    totals = {k: 0 for k in orders}
    n_total = 0
    for li, lv in enumerate(levels):
        _, h, w = lv.shape
        bh = jim._blur_band_matrix(h, 7, 2.0)
        bw = jim._blur_band_matrix(w, 7, 2.0)
        rows = np.asarray(jax.jit(jax.vmap(lambda im: jnp.dot(
            jnp.asarray(bh), im, preferred_element_type=jnp.float32)))(
                jnp.asarray(lv)))
        out = np.asarray(jax.jit(jax.vmap(lambda r: jnp.dot(
            r, jnp.asarray(bw).T, preferred_element_type=jnp.float32)))(
                jnp.asarray(rows)))
        line = [f"level {li} {h}x{w}:"]
        for name, order in orders.items():
            n1 = sum(int((contract(bh, lv[b], order) != rows[b]).sum())
                     for b in range(len(lv)))
            n2 = sum(int((contract(bw, rows[b].T, order).T != out[b]).sum())
                     for b in range(len(lv)))
            totals[name] += n1 + n2
            line.append(f"{name} {n1}/{n2}")
        n_total += 2 * rows.size
        print(" ".join(line), f"of {rows.size} each pass", flush=True)
    print("all levels, both passes:", totals, "of", n_total)
    # the port's blur before: torch.matmul; and the rounded blur
    blur = jax.jit(jax.vmap(lambda im: jim.gaussian_blur(im, 7, 2.0)))
    n_raw = n_round = n_px = 0
    for lv in levels:
        want = np.asarray(blur(jnp.asarray(lv)))
        _, h, w = lv.shape
        bh = torch.from_numpy(jim._blur_band_matrix(h, 7, 2.0))
        bw = torch.from_numpy(jim._blur_band_matrix(w, 7, 2.0))
        got = torch.matmul(torch.matmul(bh, torch.from_numpy(lv.copy())),
                           bw.T).numpy()
        n_raw += int((got != want).sum())
        n_round += int((np.clip(np.round(got), 0, 255)
                        != np.clip(np.round(want), 0, 255)).sum())
        n_px += want.size
    print(f"torch.matmul blur: {n_raw} of {n_px} outputs differ, "
          f"{n_round} after rounding")


if __name__ == "__main__":
    main()
