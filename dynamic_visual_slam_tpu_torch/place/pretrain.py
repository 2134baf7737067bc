"""Offline vocabulary pretraining — port of the reference package's
``place/pretrain.py``, the factory of the BoW vocabulary asset
(``assets/orbvoc_synth.npz``, what DBoW2's ORBvoc.txt is to the original
system).

Many viewpoints of many synthetic worlds go through the same ORB extractor
the system runs online (``frontend/orb.extract``: one launch of kernel B1
and one of B2 a frame, on the card unless the caller asks for the CPU);
hierarchical binary k-medians (``place/bow.train_vocabulary``) with one
document id a frame, for DBoW2's tf-idf weighting, builds the tree; it is
saved as an npz that ``SLAMSystem(vocab_path=...)`` or ``cli run --vocab``
loads.  The numpy ``rng`` is drawn in the reference's order, so the same
seed renders the same scenes and samples the same descriptors.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from dynamic_visual_slam_tpu_torch.config import CameraConfig, SLAMConfig
from dynamic_visual_slam_tpu_torch.frontend import orb
from dynamic_visual_slam_tpu_torch.io import synthetic
from dynamic_visual_slam_tpu_torch.pipeline.slam import resolve_device
from dynamic_visual_slam_tpu_torch.place import bow


def build_descriptor_corpus(n_scenes: int = 12, frames_per_scene: int = 24,
                            per_frame: int = 500, seed: int = 0,
                            camera: Optional[CameraConfig] = None,
                            verbose: bool = True, device: Any = "cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Render ``n_scenes`` differently seeded synthetic worlds from
    ``frames_per_scene`` viewpoints each (``camera``, default the config's
    camera scaled to 424x240) and extract ORB descriptors on ``device``.

    Returns (descs (N, 256) uint8 bits, doc_ids (N,)): the doc id is the
    global frame index, so idf counts documents the DBoW2 way."""
    dev = resolve_device(device)
    cfg = SLAMConfig()
    cam = camera or cfg.camera.scaled(424, 240)
    rng = np.random.default_rng(seed)

    descs, doc_ids = [], []
    doc = 0
    for s in range(n_scenes):
        scene = synthetic.SyntheticScene(cam, seed=int(rng.integers(1 << 30)))
        poses = synthetic.orbit_trajectory(
            frames_per_scene, seed=int(rng.integers(1 << 30)))
        for r, t in poses:
            gray, _ = scene.render(r, t)
            kp = orb.extract(torch.from_numpy(gray).to(dev), cfg.orb)
            m = kp.mask.cpu().numpy()
            d = kp.desc_bits.cpu().numpy()[m]
            if len(d) > per_frame:
                d = d[rng.choice(len(d), per_frame, replace=False)]
            descs.append(d)
            doc_ids.append(np.full(len(d), doc))
            doc += 1
        if verbose:
            print(f"scene {s + 1}/{n_scenes}: "
                  f"{sum(len(d) for d in descs)} descriptors", flush=True)
    return np.concatenate(descs), np.concatenate(doc_ids)


def train_pretrained_vocabulary(out_path: str, k: int = 10, depth: int = 3,
                                n_scenes: int = 12,
                                frames_per_scene: int = 24,
                                per_frame: int = 500, seed: int = 0,
                                verbose: bool = True,
                                device: Any = "cuda") -> dict:
    """Corpus → train → save → self-check → the reference's report.

    The self-check is the reference's (after DBoW2's integration test): each
    scene's first frame goes into a database, each scene's last frame is
    the query, and the scene's own entry must win."""
    descs, doc_ids = build_descriptor_corpus(
        n_scenes, frames_per_scene, per_frame, seed, verbose=verbose,
        device=device)
    if verbose:
        print(f"training k={k} depth={depth} vocabulary on "
              f"{len(descs)} descriptors ...", flush=True)
    voc = bow.train_vocabulary(descs, k=k, depth=depth, seed=seed,
                               doc_ids=doc_ids, device=device)
    bow.save_vocabulary(voc, out_path)

    dev = resolve_device(device)
    voc2 = bow.load_vocabulary(out_path if out_path.endswith(".npz")
                               else out_path + ".npz", dev)
    db = bow.Database(voc2, capacity=64)
    # doc ids are global frame indices (one per rendered frame, whether or
    # not it gave descriptors), so scenes are indexed directly; a frame
    # with no descriptors adds the corpus's first one, and as a query it
    # counts as a miss
    fps = frames_per_scene
    correct = 0
    for s in range(n_scenes):
        d_first = descs[doc_ids == s * fps]
        db.add(torch.from_numpy(d_first if len(d_first) else descs[:1]
                                ).to(dev))
    for s in range(n_scenes):
        d_last = descs[doc_ids == s * fps + fps - 1]
        if not len(d_last):
            continue
        res = db.query(torch.from_numpy(d_last).to(dev), top_k=1)
        if bool(res.valid[0]) and int(res.entry_ids[0]) == s:
            correct += 1
    report = dict(path=out_path, n_descriptors=int(len(descs)),
                  n_documents=int(np.unique(doc_ids).size), k=k, depth=depth,
                  n_words=int(voc.n_words),
                  scene_retrieval_accuracy=round(correct / n_scenes, 4))
    if verbose:
        print(report, flush=True)
    return report
