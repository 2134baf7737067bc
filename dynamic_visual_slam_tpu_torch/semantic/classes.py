"""Semantic category vocabulary.

Id 0 is reserved for "unlabeled" (observation outside every bbox), ids 1..80
are the COCO classes YOLOv8 emits, in standard order — the same ids as the
reference package's ``semantic/classes.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamic_visual_slam_tpu_torch.config import SLAMConfig

COCO_CLASSES: Tuple[str, ...] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush")

UNLABELED_NAME = "unlabeled"


def category_id(name: str) -> int:
    """Class name → id (0 = unlabeled; COCO classes are 1-based)."""
    if name == UNLABELED_NAME:
        return 0
    return COCO_CLASSES.index(name) + 1


def category_name(cid: int) -> str:
    return UNLABELED_NAME if cid == 0 else COCO_CLASSES[cid - 1]


def num_categories() -> int:
    return len(COCO_CLASSES) + 1


def filtered_mask(cfg: SLAMConfig, device="cuda") -> torch.Tensor:
    """(max(max_categories, 81),) bool — True for ids dropped before
    mapping (the configured filtered classes, "person" by default)."""
    n = max(cfg.map.max_categories, num_categories())
    mask = [False] * n
    for name in cfg.semantic.filtered_classes:
        mask[category_id(name)] = True
    return torch.tensor(mask, dtype=torch.bool, device=torch.device(device))
