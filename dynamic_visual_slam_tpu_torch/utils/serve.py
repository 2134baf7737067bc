"""Live operator view for `cli run --serve` (a copy of the reference
package's ``utils/serve.py``) — the reference's RViz loop
(SURVEY.md C9: markers + trajectory + annotated features subscribed live,
config/realsense.rviz:92-129) as a zero-dependency local HTTP endpoint.

The pipeline thread calls LiveView.update(...) at its own cadence; a
daemon HTTP server serves:

  /            one-page operator console: live annotated frame, stat
               tiles, and a top-down (x,z) map canvas with the landmark
               cloud + trajectory + current pose
  /frame.jpg   newest annotated feature image (JPEG)
  /stream      MJPEG multipart stream of the same (RViz-style live view)
  /stats.json  frame/keyframe/BA/loop counters + pose + fps
  /map.json    downsampled landmark cloud + trajectory polyline

Everything is plain http.server + cv2 JPEG encoding — no external
services, no egress; state handoff is a GIL-atomic swap of immutable
(bytes, dict) tuples, so the server threads never block the pipeline.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>dynamic_visual_slam_tpu live</title>
<style>
 body { background:#14161a; color:#dfe3ea; font:14px system-ui,sans-serif;
        margin:0; padding:16px; }
 h1 { font-size:16px; font-weight:600; margin:0 0 12px; }
 .row { display:flex; gap:16px; flex-wrap:wrap; }
 .card { background:#1d2026; border-radius:8px; padding:12px; }
 img, canvas { display:block; border-radius:4px; background:#000; }
 table { border-collapse:collapse; }
 td { padding:2px 10px 2px 0; font-variant-numeric:tabular-nums; }
 td:first-child { color:#9aa3b2; }
</style></head><body>
<h1>dynamic_visual_slam_tpu &mdash; live view</h1>
<div class="row">
 <div class="card"><img id="frame" src="/stream" width="640"
   onerror="this.onerror=null;this.src='/frame.jpg';"></div>
 <div class="card"><canvas id="map" width="420" height="420"></canvas></div>
 <div class="card"><table id="stats"></table></div>
</div>
<script>
async function tick() {
  try {
    const s = await (await fetch('/stats.json')).json();
    const rows = Object.entries(s).map(
      ([k, v]) => `<tr><td>${k}</td><td>${
        typeof v === 'number' ? v.toFixed ? +v.toFixed(4) : v : v
      }</td></tr>`).join('');
    document.getElementById('stats').innerHTML = rows;
    const m = await (await fetch('/map.json')).json();
    const c = document.getElementById('map'), g = c.getContext('2d');
    g.fillStyle = '#000'; g.fillRect(0, 0, c.width, c.height);
    const pts = m.landmarks_xz || [], traj = m.trajectory_xz || [];
    const all = pts.concat(traj);
    if (all.length) {
      let xs = all.map(p => p[0]), zs = all.map(p => p[1]);
      const x0 = Math.min(...xs), x1 = Math.max(...xs);
      const z0 = Math.min(...zs), z1 = Math.max(...zs);
      const s2 = 0.9 * Math.min(c.width / Math.max(x1 - x0, 1e-3),
                                c.height / Math.max(z1 - z0, 1e-3));
      const tx = p => 0.05 * c.width + (p[0] - x0) * s2;
      const tz = p => c.height - (0.05 * c.height + (p[1] - z0) * s2);
      g.fillStyle = '#39c0a5';
      for (const p of pts) g.fillRect(tx(p) - 1, tz(p) - 1, 2, 2);
      g.strokeStyle = '#e8c252'; g.lineWidth = 2; g.beginPath();
      traj.forEach((p, i) => i ? g.lineTo(tx(p), tz(p))
                               : g.moveTo(tx(p), tz(p)));
      g.stroke();
      if (traj.length) {
        const p = traj[traj.length - 1];
        g.fillStyle = '#ff6b6b';
        g.beginPath(); g.arc(tx(p), tz(p), 4, 0, 7); g.fill();
      }
    }
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveView:
    """Threaded live-view publisher. update() swaps immutable snapshots;
    HTTP handlers only read them."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1"):
        self._jpeg: Optional[bytes] = None
        self._stats: Dict[str, Any] = {}
        self._map: Dict[str, Any] = {"landmarks_xz": [], "trajectory_xz": []}
        self._seq = 0
        self._cond = threading.Condition()
        view = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.jpg":
                    jp = view._jpeg
                    if jp is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", jp)
                elif path == "/stats.json":
                    self._send(200, "application/json",
                               json.dumps(view._stats).encode())
                elif path == "/map.json":
                    self._send(200, "application/json",
                               json.dumps(view._map).encode())
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=fr")
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            with view._cond:
                                view._cond.wait_for(
                                    lambda: view._seq != last, timeout=2.0)
                                jp, last = view._jpeg, view._seq
                            if jp is None:
                                continue
                            self.wfile.write(
                                b"--fr\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(jp)}\r\n\r\n"
                                .encode())
                            self.wfile.write(jp)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError,
                            TimeoutError, OSError):
                        return
                else:
                    self._send(404, "text/plain", b"not found")

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]   # resolved (port=0 OK)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def update(self, gray: Optional[np.ndarray], uv: Optional[np.ndarray],
               stats: Dict[str, Any],
               traj_xyz: Optional[np.ndarray] = None,
               landmarks_xyz: Optional[np.ndarray] = None) -> None:
        """Publish a new snapshot (call from the pipeline thread).
        gray+uv become the annotated JPEG (uv = valid keypoint pixels —
        the reference's green feature circles, frontend.cpp:1229-1232);
        trajectory/landmarks are world xyz arrays, projected to the
        top-down (x, z) plane for the map canvas."""
        if gray is not None:
            from dynamic_visual_slam_tpu_torch.utils import viz
            img = viz.annotate_features(
                np.asarray(gray),
                uv if uv is not None else np.zeros((0, 2)))
            jp = _encode_jpeg(img)
            if jp is not None:
                with self._cond:
                    self._jpeg = jp
                    self._seq += 1
                    self._cond.notify_all()
        self._stats = dict(stats, updated=round(time.time(), 2))
        m = {}
        if landmarks_xyz is not None and len(landmarks_xyz):
            pts = np.asarray(landmarks_xyz, np.float64)
            if len(pts) > 2000:                      # bound payload size
                pts = pts[:: len(pts) // 2000 + 1]
            m["landmarks_xz"] = np.round(
                pts[:, [0, 2]], 4).tolist()
        if traj_xyz is not None and len(traj_xyz):
            tr = np.asarray(traj_xyz, np.float64)
            if len(tr) > 2000:
                tr = tr[:: len(tr) // 2000 + 1]
            m["trajectory_xz"] = np.round(tr[:, [0, 2]], 4).tolist()
        if m:
            self._map = {**self._map, **m}

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def _encode_jpeg(img: np.ndarray) -> Optional[bytes]:
    try:
        import cv2
        ok, buf = cv2.imencode(".jpg", img,
                               [int(cv2.IMWRITE_JPEG_QUALITY), 85])
        return buf.tobytes() if ok else None
    except Exception:  # cv2 unavailable: fall back to raw-PNG-less skip
        return None
