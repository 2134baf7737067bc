"""Import ultralytics YOLOv8 ``.pt`` weights into the reference's parameter
tree — port of the reference package's ``models/convert_ultralytics.py``.

The checkpoint's state dict (``model.<idx>...``) maps onto the tree that
``models/yolov8.init_params`` builds, every BatchNorm folded into the
convolution before it (eps 1e-3), in float32 numpy:

    w' = w * gamma / sqrt(var + eps)
    b' = beta - mean * gamma / sqrt(var + eps)

The heads' last 1x1 convolutions carry their own bias.  The tree comes back
as numpy float32 with HWIO ``w`` and every value rounded to bf16 (round to
nearest even), as the reference's ``_to_bf16``; ``YoloDetector(params=...)``
and ``convert.yolo_state_dict`` take it.

    params = convert("yolov8n.pt")
    save_params(params, "yolov8n.npz")

``save_params`` writes the reference's path-keyed float32 npz
(``yolo/<path>``), which both packages' ``load_params`` read;
``load_params`` lives in ``convert.py`` and is re-exported here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.convert import load_params  # noqa: F401

# ultralytics model.model module index → the parameter tree's name
_BACKBONE = [
    ("0", "stem"), ("1", "down1"), ("2", "c2f1"), ("3", "down2"),
    ("4", "c2f2"), ("5", "down3"), ("6", "c2f3"), ("7", "down4"),
    ("8", "c2f4"), ("9", "sppf"),
    ("12", "up_c2f1"), ("15", "up_c2f2"),
    ("16", "down_conv1"), ("18", "down_c2f1"),
    ("19", "down_conv2"), ("21", "down_c2f2"),
]


def _fold_bn(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Conv+BN at ``prefix`` (an ultralytics Conv module) → fused w (HWIO),
    b."""
    w = sd[f"{prefix}.conv.weight"]            # (O, I, kh, kw)
    gamma = sd[f"{prefix}.bn.weight"]
    beta = sd[f"{prefix}.bn.bias"]
    mean = sd[f"{prefix}.bn.running_mean"]
    var = sd[f"{prefix}.bn.running_var"]
    eps = 1e-3
    scale = gamma / np.sqrt(var + eps)
    w = w * scale[:, None, None, None]
    b = beta - mean * scale
    return dict(w=w.transpose(2, 3, 1, 0).astype(np.float32),
                b=b.astype(np.float32))


def _plain_conv(sd: Dict[str, np.ndarray], prefix: str
                ) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"]
    b = sd.get(f"{prefix}.bias", np.zeros(w.shape[0], np.float32))
    return dict(w=w.transpose(2, 3, 1, 0).astype(np.float32),
                b=b.astype(np.float32))


def _c2f(sd, prefix):
    out = dict(cv1=_fold_bn(sd, f"{prefix}.cv1"),
               cv2=_fold_bn(sd, f"{prefix}.cv2"), m=[])
    i = 0
    while f"{prefix}.m.{i}.cv1.conv.weight" in sd:
        out["m"].append(dict(cv1=_fold_bn(sd, f"{prefix}.m.{i}.cv1"),
                             cv2=_fold_bn(sd, f"{prefix}.m.{i}.cv2")))
        i += 1
    return out


def convert(pt_path: str) -> Dict[str, Any]:
    """ultralytics yolov8*.pt → the parameter tree (numpy float32 holding
    bf16 values, and ``num_classes``).  The checkpoint pickles its module,
    so it is loaded with ``weights_only=False``: convert only files you
    trust."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    model = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt \
        else ckpt
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    root = "model"

    params: Dict[str, Any] = {}
    for idx, name in _BACKBONE:
        prefix = f"{root}.{idx}"
        if name.startswith(("c2f", "up_c2f", "down_c2f")):
            params[name] = _c2f(sd, prefix)
        elif name == "sppf":
            params[name] = dict(cv1=_fold_bn(sd, f"{prefix}.cv1"),
                                cv2=_fold_bn(sd, f"{prefix}.cv2"))
        else:
            params[name] = _fold_bn(sd, prefix)

    heads = []
    det = f"{root}.22"
    for s in range(3):
        heads.append(dict(
            box1=_fold_bn(sd, f"{det}.cv2.{s}.0"),
            box2=_fold_bn(sd, f"{det}.cv2.{s}.1"),
            box3=_plain_conv(sd, f"{det}.cv2.{s}.2"),
            cls1=_fold_bn(sd, f"{det}.cv3.{s}.0"),
            cls2=_fold_bn(sd, f"{det}.cv3.{s}.1"),
            cls3=_plain_conv(sd, f"{det}.cv3.{s}.2")))
    params["heads"] = heads
    params["num_classes"] = heads[0]["cls3"]["w"].shape[-1]
    return round_bf16(params)


def round_bf16(tree):
    """Every float array of the tree rounded to bf16 (round to nearest
    even, as the reference's cast), kept as numpy float32."""
    if isinstance(tree, dict):
        return {k: round_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [round_bf16(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return torch.from_numpy(np.ascontiguousarray(tree, np.float32)).to(
            torch.bfloat16).to(torch.float32).numpy()
    return tree


def save_params(params: Dict[str, Any], path: str) -> None:
    """Flatten the tree to the reference's path-keyed npz (``yolo/<path>``,
    float32), ``num_classes`` and ``input_size`` included as scalars."""
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                rec(v, f"{prefix}/{i}")
        else:
            flat[prefix] = np.asarray(node, np.float32)

    rec(params, "yolo")
    np.savez_compressed(path, **flat)
