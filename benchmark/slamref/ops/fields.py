"""FAST-9 scores of every pyramid level of a batch: the plain version of
kernel B1 (``ops/fast.corner_score``, level by level) on any device."""

from __future__ import annotations

from typing import List, Sequence

import torch

from slamref.ops.fast import corner_score


def fast_score_batch(levels: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per level a (B, H_l, W_l) float32 score tensor."""
    return [corner_score(lv) for lv in levels]
