"""PyTorch port vs the JAX reference: place/pretrain (the vocabulary
factory), on the CPU.

Tolerances: none.  ``build_descriptor_corpus`` gives the same descriptor
bits and document ids as the reference's (the same scenes, the same ORB
extraction, the same numpy draws), and ``train_pretrained_vocabulary``
the same report and the same saved vocabulary.  (At 424x240 over 96
frames, 4 bits in 3 frames differ: the blur's last-ulp fault, ROADMAP §C;
these small corpora have none.)
"""

import numpy as np
import pytest
import torch

from dynamic_visual_slam_tpu.config import CameraConfig as JCam
from dynamic_visual_slam_tpu.place import pretrain as jpre
from dynamic_visual_slam_tpu_torch.config import CameraConfig as PCam
from dynamic_visual_slam_tpu_torch.place import pretrain as ppre

torch.set_num_threads(2)


def test_corpus_matches_reference():
    kw = dict(width=160, height=120, fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    want_d, want_doc = jpre.build_descriptor_corpus(
        2, 3, per_frame=300, seed=4, camera=JCam(**kw), verbose=False)
    got_d, got_doc = ppre.build_descriptor_corpus(
        2, 3, per_frame=300, seed=4, camera=PCam(**kw), verbose=False,
        device="cpu")
    assert got_d.dtype == np.uint8 and got_d.shape[1] == 256
    assert len(np.unique(got_doc)) == 6 and len(got_d) > 600
    np.testing.assert_array_equal(got_doc, want_doc)
    np.testing.assert_array_equal(got_d, want_d)


def test_pretrained_vocabulary_report_matches(tmp_path):
    kw = dict(k=4, depth=2, n_scenes=2, frames_per_scene=3, per_frame=200,
              seed=0, verbose=False)
    want = jpre.train_pretrained_vocabulary(str(tmp_path / "ref.npz"), **kw)
    got = ppre.train_pretrained_vocabulary(str(tmp_path / "port.npz"),
                                           device="cpu", **kw)
    assert got.pop("path").endswith("port.npz")
    want.pop("path")
    assert got == want
    assert got["n_words"] == 16 and got["n_descriptors"] == 1200
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in b.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_corpus_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ppre.build_descriptor_corpus(1, 1, verbose=False)
