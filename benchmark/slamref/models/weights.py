"""YOLOv8 weights from the reference's npz (frozen copy of the port's
``convert.load_params`` / ``yolo_state_dict``) and the model built from
them."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from slamref.models import yolov8


def load_params(path: str) -> Dict[str, Any]:
    """The reference's YOLOv8 npz (``yolo/<path>`` keys, float32 arrays) →
    its nested parameter tree as numpy: dicts, lists where every key is a
    digit, ``num_classes`` from the last class convolution, and the
    scalar ``input_size`` when the file embeds one."""
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")[1:]
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key], np.float32)
    return _yolo_tree(root)


def _yolo_tree(root: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts keyed by path parts → the parameter tree: a dict whose
    keys are all digits becomes a list; ``num_classes`` from the last class
    convolution."""
    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    params = listify(root)
    params["num_classes"] = params["heads"][0]["cls3"]["b"].shape[0]
    return params


def yolo_state_dict(params: Mapping[str, Any], dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """The reference's YOLOv8 parameter tree (numpy: from ``load_params``,
    or ``np.asarray`` of its ``init_params``) → ``YOLOv8``'s state dict:
    ``w`` HWIO → OIHW, every array cast to ``dtype``: bf16 rounds to
    nearest even, as the reference's cast; float32 keeps training masters
    as they are.  ``num_classes`` and ``input_size`` are not weights and
    are skipped."""
    out: Dict[str, torch.Tensor] = {}

    def rec(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if prefix or k not in ("num_classes", "input_size"):
                    rec(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}.")
        else:
            a = np.asarray(node, np.float32)
            if prefix.endswith("w."):
                a = a.transpose(3, 2, 0, 1)
            out[prefix[:-1]] = torch.from_numpy(
                np.ascontiguousarray(a)).to(dtype)

    rec(params, "")
    return out


def build_model(path: str, device):
    """YOLOv8 in eval mode on ``device`` from the npz at ``path``, and its
    embedded input size (None when the file embeds none)."""
    params = load_params(path)
    model = yolov8.YOLOv8(int(params["heads"][0]["cls3"]["b"].shape[0]))
    model.load_state_dict(yolo_state_dict(params))
    size = int(np.asarray(params["input_size"], np.float32)) \
        if "input_size" in params else None
    return model.to(device).eval(), size
