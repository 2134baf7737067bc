"""PyTorch port vs the JAX reference: semantic/train (the YOLOv8n trainer)
and its optimizer, on the CPU.

Tolerances, and why:
- ``_anchor_grid``, ``_assign`` (on the reference test's boxes and on
  random ones), the pool's boxes and masks: exact.  ``_dfl_loss``: within
  1e-6 (log_softmax in two libraries).
- ``letterbox_np`` and ``render_pool``'s images: within 1e-5 (the
  detector's letterbox, tests/test_torch_detector.py); the pool rendered in
  worker processes equals the serial render exactly.
- ``detection_loss`` and its gradients, JAX's ``init_params(key(0))``
  carried across as float32 masters, 4 rendered images at 128: the loss
  within LOSS_REL_TOL of the reference's, each parameter's gradient within
  GRAD_REL_TOL (norm of the difference over the norm).  Both run the
  reference's rounding points (bf16 inputs and weights, bf16 activations)
  with sums in other orders, so activations now and then round to the
  neighbouring bf16 value and the gradients inherit that; the deepest
  layers (stride 32, 4x4 maps at 128) sum the fewest terms and differ most.
  Measured worst, this file run alone on an AVX-512 host under MKL_CBWR
  AVX2, AVX512 and COMPATIBLE, each with ATEN_CPU_CAPABILITY default and
  avx2: loss 5.24e-7 relative in every setting, gradients 0.0343 to
  0.0343 (``c2f4.m.0.cv1.w``; median leaf 0.0021); bounds 1.5 times the
  worst.
- the optimizer (``OptaxAdamW``: clip to global norm 10, AdamW with decay
  1e-5, cosine schedule with alpha 0.05): five steps on a fixed sequence of
  gradients, some above the clip norm, against optax's chain: each
  parameter within 1e-6 (norm of the difference over the parameter's
  norm; measured 3.0e-7: torch forms Adam's bias corrections and the
  decoupled decay in another order, a last-bit difference in each
  element's update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamic_visual_slam_tpu.models import yolov8 as jy
from dynamic_visual_slam_tpu.semantic import train as JT
from dynamic_visual_slam_tpu_torch import convert
from dynamic_visual_slam_tpu_torch.models import yolov8 as py
from dynamic_visual_slam_tpu_torch.models.convert_ultralytics import \
    round_bf16
from dynamic_visual_slam_tpu_torch.semantic import train as PT

torch.set_num_threads(2)
LOSS_REL_TOL = 7.9e-7
GRAD_REL_TOL = 0.0515


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _np_tree(jp):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jp)


@pytest.mark.parametrize("size", [96, 128, 256])
def test_anchor_grid_is_exact(size):
    jpts, jstr = JT._anchor_grid(size)
    ppts, pstr = PT._anchor_grid(size)
    np.testing.assert_array_equal(ppts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(pstr.numpy(), np.asarray(jstr))


def _gt(rows):
    gt = np.zeros((JT.MAX_GT, 4), np.float32)
    gt[:len(rows)] = rows
    return gt, np.arange(JT.MAX_GT) < len(rows)


def test_assign_is_exact():
    """The reference test's boxes (one box; a big box holding a small one),
    and 6 images of random boxes, some padded, batched in the port."""
    rng = np.random.default_rng(0)
    cases = [_gt([[32.0, 32.0, 96.0, 96.0]]),
             _gt([[8.0, 8.0, 120.0, 120.0], [48.0, 48.0, 80.0, 80.0]])]
    for n in range(6):
        xy = rng.uniform(-8, 120, (n + 1, 2)).astype(np.float32)
        wh = rng.uniform(4, 100, (n + 1, 2)).astype(np.float32)
        cases.append(_gt(np.concatenate([xy, xy + wh], 1)))
    gt = np.stack([c[0] for c in cases])
    mask = np.stack([c[1] for c in cases])
    jpts, jstr = JT._anchor_grid(128)
    ppts, pstr = PT._anchor_grid(128)
    idx, pos = PT._assign(ppts, pstr, torch.from_numpy(gt),
                          torch.from_numpy(mask))
    n_pos = 0
    for i in range(len(cases)):
        jidx, jpos = JT._assign(jpts, jstr, jnp.asarray(gt[i]),
                                jnp.asarray(mask[i]))
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        n_pos += int(np.asarray(jpos).sum())
    assert n_pos > 50


def test_dfl_loss_matches():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (64, 4, py.REG_MAX)).astype(np.float32)
    target = rng.uniform(0, py.REG_MAX - 1 - 1e-3, (64, 4)).astype(
        np.float32)
    target[:4] = [0.0, 2.0, 7.0, 14.999]           # integer bins and ends
    want = np.asarray(JT._dfl_loss(jnp.asarray(logits), jnp.asarray(target)))
    got = PT._dfl_loss(torch.from_numpy(logits),
                       torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_letterbox_np_matches():
    rng = np.random.default_rng(0)
    for shape, size in (((96, 128), 64), ((240, 320), 128), ((120, 160),
                                                             256)):
        gray = rng.integers(0, 255, shape).astype(np.float32)
        want, ws, wp = JT.letterbox_np(gray, size)
        got, gs, gp = PT.letterbox_np(gray, size)
        assert (gs, gp) == (ws, wp)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_pool_matches_and_workers_equal_serial():
    want = JT.render_pool(7, input_size=96, seed=3)
    got = PT.render_pool(7, input_size=96, seed=3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].any()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    # render_pool renders 3 scenes serially; the same plan in 2 workers
    plan = PT.pool_plan(7, 3)
    serial = PT.render_scenes(PT.POOL_CAMERA, 96, plan)
    par = PT.render_scenes(PT.POOL_CAMERA, 96, plan, workers=2)
    assert len(par) == len(serial) == 7
    for (a, ab), (b, bb), img in zip(par, serial, got[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ab, bb)
        np.testing.assert_array_equal(a, img)


@pytest.fixture(scope="module")
def loss_case():
    imgs, boxes, mask = JT.render_pool(4, input_size=128, seed=1)
    jp = JT._to_f32(jy.init_params(jax.random.key(0)))
    jp.pop("num_classes")
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        JT.detection_loss, has_aux=True), static_argnums=4)(
        jp, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(mask), 128)
    return dict(imgs=imgs, boxes=boxes, mask=mask, params=_np_tree(jp),
                loss=float(jl), aux={k: float(v) for k, v in jaux.items()},
                grads=dict(_leaves(_np_tree(jg))))


def test_detection_loss_and_gradients_match(loss_case):
    c = loss_case
    model = PT.trainable_model(c["params"], "cpu")
    loss, aux = PT.detection_loss(
        model, torch.from_numpy(c["imgs"]), torch.from_numpy(c["boxes"]),
        torch.from_numpy(c["mask"]), 128)
    loss.backward()
    assert float(aux["n_pos"]) == c["aux"]["n_pos"] > 0
    loss_rel = abs(float(loss) - c["loss"]) / abs(c["loss"])
    grads = dict(_leaves(convert.yolo_params(
        {n: p.grad for n, p in model.named_parameters()})))
    grads.pop("/num_classes")
    assert grads.keys() == c["grads"].keys()
    rel = {k: float(np.linalg.norm(grads[k] - g) / np.linalg.norm(g))
           for k, g in c["grads"].items()}
    worst = max(rel, key=rel.get)
    print(f"loss {float(loss)} against {c['loss']}, relative {loss_rel:.3g};"
          f" gradients: worst {rel[worst]:.4f} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.4f}")
    assert loss_rel <= LOSS_REL_TOL
    assert rel[worst] <= GRAD_REL_TOL


def test_optimizer_matches_optax():
    """Five steps of OptaxAdamW against the reference's optax chain on the
    same fixed gradients (steps 2 and 4 above the clip norm)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 8), (8,), (16,)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 0.5 if t % 2 == 0 else 20.0, s).astype(
        np.float32) for s in shapes] for t in range(5)]
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(
        optax.cosine_decay_schedule(1e-2, 5, alpha=0.05),
        weight_decay=1e-5))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = PT.OptaxAdamW(params, 1e-2, 5)
    for g in grads:
        up, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, up)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for p, want in zip(params, jp):
        want = np.asarray(want)
        err = np.linalg.norm(p.detach().numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-6, err
    assert [PT.cosine_decay(1e-2, 5, 0.05, c) for c in range(7)] == \
        pytest.approx([float(optax.cosine_decay_schedule(
            1e-2, 5, alpha=0.05)(c)) for c in range(7)], rel=1e-6)


def test_short_run_halves_the_loss():
    """The reference's can-it-learn check: one fixed batch, 25 Adam steps
    at 2e-3 (tests/test_semantic_train.py): the loss must halve, and the
    first gradients reach the stem."""
    imgs, boxes, mask = (torch.from_numpy(a) for a in
                         PT.render_pool(4, input_size=128, seed=1))
    model = PT.trainable_model(py.init_params(
        torch.Generator().manual_seed(0)), "cpu")
    opt = torch.optim.Adam(model.parameters(), 2e-3)
    losses = []
    for it in range(25):
        opt.zero_grad()
        loss, _ = PT.detection_loss(model, imgs, boxes, mask, 128)
        loss.backward()
        if it == 0:
            g = float(model.stem.w.grad.norm())
            assert np.isfinite(g) and g > 0
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses[-1])
    assert losses[-1] < 0.5 * losses[0], losses


def test_train_step_runs_deterministic_convolutions(monkeypatch):
    """A training step's forward and backward run under cuDNN's
    deterministic algorithms (on the card its default weight gradients
    change between calls), and the flags are restored after it."""
    seen = []
    loss_fn = PT.detection_loss

    def spy(*a):
        seen.append((torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.allow_tf32))
        return loss_fn(*a)
    monkeypatch.setattr(PT, "detection_loss", spy)
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32)
    imgs, boxes, mask = (torch.from_numpy(a) for a in
                         PT.render_pool(2, input_size=64, seed=1))
    model = PT.trainable_model(py.init_params(
        torch.Generator().manual_seed(0)), "cpu")
    opt = PT.OptaxAdamW(model.parameters(), 1e-3, 5)
    loss, _ = PT.train_step(model, opt, imgs, boxes, mask, 64)
    assert np.isfinite(float(loss))
    assert seen == [(True, False)]
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32) == before


def test_train_returns_bf16_params_and_its_loss_falls(tmp_path):
    params, hist = PT.train(steps=30, batch=4, input_size=64,
                            pool_images=8, lr=2e-3, log_every=10,
                            verbose=False, device="cpu")
    assert len(hist) == 4 and hist[-1] < hist[0], hist
    leaves = [v for k, v in _leaves(params) if k != "/num_classes"]
    assert len(leaves) == 126 and params["num_classes"] == 80
    for v in leaves:
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, round_bf16(v))
    # the reference's loader reads it once saved
    from dynamic_visual_slam_tpu.models.convert_ultralytics import \
        load_params as jload
    from dynamic_visual_slam_tpu_torch.models.convert_ultralytics import \
        save_params
    save_params(dict(params, input_size=64), str(tmp_path / "w.npz"))
    back = jload(str(tmp_path / "w.npz"))
    np.testing.assert_array_equal(np.asarray(back["stem"]["w"], np.float32),
                                  params["stem"]["w"])
    m = PT.evaluate(params, input_size=64, n_images=4, seed=77, device="cpu")
    assert set(m) == {"mean_best_iou", "recall", "precision", "n_gt",
                      "n_detections"}
    assert 0.0 <= m["mean_best_iou"] <= 1.0


def test_in_loop_eval_report():
    """The report's schema at 160x120 and 12 frames, with a random-init
    detector at input size 64: the reference's keys plus the port's
    ``person_landmarks``, for each condition."""
    params = py.init_params(torch.Generator().manual_seed(0))
    params["input_size"] = 64
    res = PT.in_loop_eval(params, n_frames=12, width=160, height=120,
                          conditions=("off", "learned"), verbose=False,
                          device="cpu")
    assert set(res) == {"off", "learned"}
    keys = {"ate_m", "walker_landmarks_confirmed", "walker_landmarks_any",
            "landmarks", "keyframes", "person_landmarks"}
    assert set(res["off"]) == keys
    assert set(res["learned"]) == keys | {"detections_total"}
    for r in res.values():
        assert np.isfinite(r["ate_m"]) and r["landmarks"] > 0
