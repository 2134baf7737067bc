"""The port's live view (``utils/serve.LiveView``, behind ``cli run
--serve``) against the reference package's: both serve on 127.0.0.1 on a
free port, are fed the same updates, and must answer ``/``,
``/stats.json``, ``/map.json``, ``/frame.jpg``, ``/stream``'s first part
and an unknown path with equal bodies (tolerance: none).  The stat tiles'
``updated`` stamp reads the wall clock, so both modules get one fixed
clock."""

import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from dynamic_visual_slam_tpu.utils import serve as jserve
from dynamic_visual_slam_tpu_torch.utils import serve as pserve

PATHS = ["/", "/stats.json", "/map.json", "/frame.jpg", "/nope"]


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _first_stream_part(port: int) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                timeout=10) as r:
        head = b""
        while b"\r\n\r\n" not in head:
            head += r.read(1)
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        return head + r.read(n)


def _updates():
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (120, 160)).astype(np.float32)
    uv = rng.uniform([0, 0], [160, 120], (40, 2))
    traj = np.cumsum(rng.normal(0, 0.01, (30, 3)), axis=0)
    lms = rng.normal(0, 1, (4500, 3))          # > 2000: downsampled
    stats = dict(frames=30, keyframes=3, ba_runs=1, x=0.1, tracking_ok=True)
    return [(gray, uv, stats, traj, lms),
            (None, None, dict(stats, frames=31), traj[:10], None)]


@pytest.mark.parametrize("n_updates", [0, 1, 2])
def test_bodies_equal_the_reference(monkeypatch, n_updates):
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.123)
    views = []
    try:
        for mod in (jserve, pserve):
            monkeypatch.setattr(mod, "time", clock)
            views.append(mod.LiveView(port=0))
        want_view, got_view = views
        for args in _updates()[:n_updates]:
            want_view.update(*args)
            got_view.update(*args)
        for path in PATHS:
            want = _get(want_view.port, path)
            got = _get(got_view.port, path)
            assert got == want, path
        if n_updates:
            assert _get(got_view.port, "/frame.jpg")[2][:3] == \
                b"\xff\xd8\xff"
            assert _first_stream_part(got_view.port) == \
                _first_stream_part(want_view.port)
        else:
            assert _get(got_view.port, "/frame.jpg")[0] == 404
    finally:
        for v in views:
            v.close()
    assert got_view.port != 0
