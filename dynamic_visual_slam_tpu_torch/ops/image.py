"""Image ops: pyramid, Gaussian blur, reflect padding — batched torch.

Behaviour reproduced (as in the reference package's ``ops/image.py``):
- 8-level pyramid, scale 1.2, bilinear resize with half-pixel centres,
  BORDER_REFLECT_101 borders;
- 7x7 Gaussian sigma=2 blur before descriptor sampling.

Images are (..., H, W) float32 grayscale in [0, 255]; every function takes
any number of leading batch dims.  The resize and blur follow the
reference's formulas term for term (not ``F.interpolate`` / ``conv2d``):
their outputs are rounded to integers afterwards, and a different
summation order can move a pixel that sits on a .5 boundary by one.  The
resize also forms the reference's fused multiply-adds (``resize_bilinear``).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float
                   ) -> List[Tuple[int, int]]:
    """Per-level (H, W), matching cv::resize(round(size/scale^l)) semantics."""
    return [(int(round(h / scale_factor ** l)), int(round(w / scale_factor ** l)))
            for l in range(n_levels)]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the product
    of two float32 values is exact in float64, the sum is formed there and
    rounded to float32 at the end.  b and c are float32 tensors, or Python
    floats holding float32 values."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    return (a.double() * f64(b) + f64(c)).to(torch.float32)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (cv::INTER_LINEAR convention).

    The reference's XLA program on an x86 host with FMA3 contracts three
    steps into fused multiply-adds: the source coordinate
    fma(i + 0.5, h/out_h, -0.5), and each of the two interpolations
    fma(a, 1 - w, b * w) with b * w rounded first.  The levels are rounded
    to integers afterwards, so one last-ulp difference can move a pixel on
    a .5 boundary by one: the same fmas are formed here, in float64 on
    every device, and the levels equal the reference's pixel for pixel."""
    h, w = img.shape[-2:]
    dev = img.device
    f32 = torch.float32
    ys = _fma(torch.arange(out_h, dtype=f32, device=dev) + 0.5,
              float(np.float32(h / out_h)), -0.5)
    xs = _fma(torch.arange(out_w, dtype=f32, device=dev) + 0.5,
              float(np.float32(w / out_w)), -0.5)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    top = img[..., y0i, :]          # (..., out_h, w)
    bot = img[..., y1i, :]
    rows = _fma(top, (1 - wy)[:, None], bot * wy[:, None])
    left = rows[..., x0i]           # (..., out_h, out_w)
    right = rows[..., x1i]
    return _fma(left, (1 - wx)[None, :], right * wx[None, :])


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float,
                  quantize: bool = True) -> Tuple[torch.Tensor, ...]:
    """Level 0 is the input; each level resized from the previous.

    quantize rounds each level to integral values (half to even, as
    ``jnp.round``), reproducing the reference's uint8 pipeline."""
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        nxt = resize_bilinear(levels[-1], *shapes[l])
        if quantize:
            nxt = torch.clamp(torch.round(nxt), 0.0, 255.0)
        levels.append(nxt)
    return tuple(levels)


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """BORDER_REFLECT_101 (edge pixel not duplicated) on the last two dims."""
    lead = img.shape[:-2]
    x = img.reshape((-1,) + img.shape[-2:])
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return x.reshape(lead + x.shape[-2:])


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel equivalent."""
    xs = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_band_matrix(n: int, ksize: int, sigma: float) -> np.ndarray:
    """(n, n) banded matrix applying the 1D Gaussian with REFLECT_101
    boundary folded in: out = B @ signal."""
    k = gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    b = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for j, w in enumerate(k):
            src = i + j - half
            if src < 0:
                src = -src
            elif src >= n:
                src = 2 * (n - 1) - src
            b[i, src] += w
    return b


@functools.lru_cache(maxsize=64)
def _band_tensor(n: int, ksize: int, sigma: float, device: torch.device
                 ) -> torch.Tensor:
    """_blur_band_matrix as a tensor on ``device``, uploaded once."""
    return torch.from_numpy(_blur_band_matrix(n, ksize, sigma)).to(device)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian with REFLECT_101 borders as two banded f32 matmuls
    out = B_H · img · B_Wᵀ — the reference's formulation, kept so the sums
    run over the same folded weights (TF32 is off package-wide)."""
    h, w = img.shape[-2:]
    bh = _band_tensor(h, ksize, sigma, img.device)
    bw = _band_tensor(w, ksize, sigma, img.device)
    rows = torch.matmul(bh, img)
    return torch.matmul(rows, bw.T)


def maxpool_same(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """size x size max filter, same-shape, -inf padded — for NMS."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), size, stride=1,
                     padding=size // 2)
    return y.reshape(lead + x.shape[-2:])


def cell_reduce_max(x: torch.Tensor, cell: int) -> torch.Tensor:
    """Max over non-overlapping cell x cell tiles anchored at (0,0)
    → (..., ceil(H/c), ceil(W/c)); the ragged edge is -inf padded."""
    h, w = x.shape[-2:]
    hc, wc = -(-h // cell), -(-w // cell)
    xpad = F.pad(x, (0, wc * cell - w, 0, hc * cell - h), value=-float("inf"))
    t = xpad.reshape(x.shape[:-2] + (hc, cell, wc, cell))
    return t.amax(dim=(-3, -1))


def cell_broadcast(cells: torch.Tensor, cell: int, h: int, w: int) -> torch.Tensor:
    """Inverse of cell_reduce_max's shape: repeat each cell value over its tile."""
    up = cells.repeat_interleave(cell, dim=-2).repeat_interleave(cell, dim=-1)
    return up[..., :h, :w]


def to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) uint8/float RGB → (H,W) float32 gray, BT.601 (cv::cvtColor)."""
    rgb = rgb.to(torch.float32)
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
