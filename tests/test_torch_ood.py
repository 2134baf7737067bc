"""The port's out-of-distribution detector eval (``dynamic_visual_slam_tpu_
torch/evaluation/ood.py``), the counterpart of the reference's
``scripts/ood_eval.py``, on the CPU at 12 frames with culling off and
ground-truth boxes (the learned condition is the same ``in_loop_eval``
call, held by tests/test_torch_train.py): the printed JSON has the
reference script's two keys, each with ``in_loop_eval``'s report of the
two conditions; the in-distribution call runs the default walkers and the
out-of-distribution one ``synthetic.hard_walkers(n_frames)``; the weights
are the shipped ones, loaded by the port's loader.
"""

import contextlib
import io
import json

import torch

from dynamic_visual_slam_tpu_torch.evaluation import ood
from dynamic_visual_slam_tpu_torch.io import synthetic

torch.set_num_threads(2)
N = 12
CONDITIONS = ("off", "gt")


def test_prints_both_halves_with_hard_walkers_out_of_distribution(
        monkeypatch):
    calls = []
    real = ood.train.in_loop_eval

    def in_loop_eval(params, **kw):
        calls.append(kw)
        assert params["input_size"] == 256
        return real(params, conditions=CONDITIONS, verbose=False, **kw)

    monkeypatch.setattr(ood.train, "in_loop_eval", in_loop_eval)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ood.main([str(N), "--device", "cpu"]) == 0
    text = buf.getvalue()
    out = json.loads(text[text.rindex("\n{\n") + 1:])
    assert set(out) == {"in_distribution", "out_of_distribution"}
    for half in out.values():
        assert set(half) == set(CONDITIONS)
        for rep in half.values():
            assert {"ate_m", "walker_landmarks_confirmed",
                    "walker_landmarks_any", "landmarks",
                    "keyframes"} <= set(rep)
    assert [c["n_frames"] for c in calls] == [N, N]
    assert [c["seed"] for c in calls] == [0, 0]
    assert "objects" not in calls[0]
    assert calls[1]["objects"] == synthetic.hard_walkers(N)
    assert text.startswith(f"weights: {ood.WEIGHTS}\n")
