"""The accuracy evaluations behind the README's claims, on the port:

- ``parity_sweep``: the 12-cell parity matrix against the CPU oracle
  (``scripts/torch_parity_sweep.py``);
- ``loop720p``: loop closure at the shipped 720p defaults with injected
  depth drift (``scripts/torch_loop720p.py``);
- ``ood``: the shipped detector in the loop on out-of-distribution walkers
  (``scripts/torch_ood_eval.py``).

Each module has ``main(argv=None) -> int``; ``--device`` defaults to
``cuda`` and raises without a card."""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

import torch


def card(device) -> Tuple[str, Optional[str]]:
    """(name, power limit) of the device a run used: the card's name as
    ``torch.cuda.get_device_name`` gives it and its power limit as
    ``nvidia-smi --query-gpu=power.limit`` gives it; ("cpu", None) on the
    CPU.  Raises when nvidia-smi fails on a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return torch.cuda.get_device_name(index), smi.stdout.strip()
