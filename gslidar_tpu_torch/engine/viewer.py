"""Live training viewer: browser-based orbit + fly camera over HTTP (the
port's copy of gslidar_tpu/engine/viewer.py; ``close`` added, so that a
training run stops its server when it ends).

Reference: utils/viser_utils.py + thirdparty/nerfview (a viser web viewer
with a render callback, a train-loop lock, pause control, and rays/sec
accounting). viser is not available in this environment, so this is a
dependency-free equivalent on http.server:

* the page polls /render with either ORBIT parameters (az/el/dist
  sliders) or a FREE-FLY pose (WASD + mouse-drag compute position/yaw/
  pitch client side) — the nerfview free-perspective equivalent;
* /pause toggles training: checkin() blocks while paused, exactly like
  nerfview's ``while status == "paused": sleep`` (viser_utils.py:43-45);
* /stats reports rays/sec computed from the checkin/checkout bracket
  (viser_utils.py:49-55).

* while the camera moves (mouse drag or a movement key held) the page
  asks /render?preview=1 and the callback renders its half-resolution
  twin, switching back to full resolution once the camera
  settles — nerfview's moving-resolution degradation
  (thirdparty/nerfview/nerfview/_renderer.py).
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>gslidar_tpu viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace }
img { image-rendering:pixelated; width:90vw }
#view:focus { outline:1px solid #5af }
</style></head><body>
<div>mode <select id=mode><option>orbit</option><option>fly</option></select>
 az <input id=az type=range min=-180 max=180 value=0>
 el <input id=el type=range min=-60 max=60 value=15>
 dist <input id=dist type=range min=2 max=80 value=25>
 frame <input id=frame type=range min=0 max=FRAME_MAX value=0>
 <button id=pause>pause</button>
 <span id=stat></span></div>
<div>fly: click image, WASD+RF to move, drag to look</div>
<img id=view tabindex=0>
<script>
let pos = [0, -2, -10], yaw = 0, pitch = 0, paused = false;
const keys = {};
const view = document.getElementById('view');
view.onkeydown = e => keys[e.key.toLowerCase()] = true;
view.onkeyup = e => keys[e.key.toLowerCase()] = false;
let drag = null;
let lastQ = '';
view.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.4; pitch += (e.clientY - drag[1]) * 0.3;
  pitch = Math.max(-89, Math.min(89, pitch));
  drag = [e.clientX, e.clientY];
};
function step() {
  const y = yaw * Math.PI / 180, p = pitch * Math.PI / 180, v = 0.8;
  const fwd = [Math.cos(p)*Math.sin(y), -Math.sin(p), Math.cos(p)*Math.cos(y)];
  const right = [Math.cos(y), 0, -Math.sin(y)];
  const mv = (d, s) => { for (let i = 0; i < 3; i++) pos[i] += d[i]*s; };
  if (keys['w']) mv(fwd, v);   if (keys['s']) mv(fwd, -v);
  if (keys['d']) mv(right, v); if (keys['a']) mv(right, -v);
  if (keys['r']) pos[1] -= v;  if (keys['f']) pos[1] += v;
}
document.getElementById('pause').onclick = async () => {
  const r = await fetch('/pause', {method: 'POST'});
  paused = (await r.json()).paused;
  document.getElementById('pause').textContent = paused ? 'resume' : 'pause';
};
async function tick() {
  step();
  let q;
  if (document.getElementById('mode').value === 'fly') {
    q = 'mode=fly&px=' + pos[0] + '&py=' + pos[1] + '&pz=' + pos[2]
      + '&yaw=' + yaw + '&pitch=' + pitch;
  } else {
    q = 'mode=orbit&' + ['az','el','dist'].map(k =>
        k + '=' + document.getElementById(k).value).join('&');
  }
  q += '&frame=' + document.getElementById('frame').value;
  // the camera "moves" when the mouse drags, a fly key is held, OR an
  // orbit/frame slider changed since the last tick — all three ask for
  // the half-resolution preview render
  const slid = q !== lastQ; lastQ = q;
  if (drag || slid || Object.values(keys).some(v => v)) q += '&preview=1';
  const t0 = performance.now();
  try {
    const r = await fetch('/render?' + q);
    if (r.ok) {
      const b = await r.blob();
      document.getElementById('view').src = URL.createObjectURL(b);
      const s = await (await fetch('/stats')).json();
      document.getElementById('stat').textContent =
          (performance.now() - t0).toFixed(0) + ' ms | ' +
          (s.rays_per_sec / 1e6).toFixed(2) + ' Mrays/s';
    }
  } catch (e) {}
  setTimeout(tick, 250);
}
tick();
</script></body></html>"""


class VisManager:
    """Train-loop-integrated viewer (reference utils/viser_utils.py)."""

    def __init__(self, cfg: dict, render_fn=None):
        import inspect
        self.cfg = cfg
        self.render_fn = render_fn
        try:
            self._fn_takes_preview = render_fn is not None and len(
                inspect.signature(render_fn).parameters) >= 3
        except (TypeError, ValueError):
            self._fn_takes_preview = False
        self.lock = threading.Lock()
        self.iter_t0 = None
        self.rays_per_sec = 0.0
        self.paused = False
        self.pixels_per_step = cfg.get("pixels_per_step", 66 * 515)
        self.max_frame = int(cfg.get("max_frame", 1))
        self.server = None
        self.port = cfg.get("port", 8080)
        if cfg.get("enabled", True) and render_fn is not None:
            try:
                self._start_server(self.port)
            except OSError as e:
                print(f"[viewer] disabled (port {self.port}: {e})")

    # -- train-loop protocol (reference viser_utils.py:43-55) -------------
    def checkin(self):
        while self.paused:           # nerfview's paused state
            time.sleep(0.05)
        self.lock.acquire()
        self.iter_t0 = time.perf_counter()

    def checkout(self, iteration=None):
        if self.iter_t0 is not None:
            dt = max(time.perf_counter() - self.iter_t0, 1e-9)
            self.rays_per_sec = self.pixels_per_step / dt
        self.lock.release()

    def close(self):
        """Stop the server (if one started) and release its socket."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None

    # -- http -------------------------------------------------------------
    def _start_server(self, port: int):
        mgr = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if urlparse(self.path).path == "/pause":
                    mgr.paused = not mgr.paused
                    body = json.dumps({"paused": mgr.paused}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(404)
                self.end_headers()

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _PAGE.replace("FRAME_MAX",
                                         str(mgr.max_frame - 1)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/stats":
                    body = json.dumps(
                        {"rays_per_sec": mgr.rays_per_sec,
                         "paused": mgr.paused}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/render":
                    q = parse_qs(url.query)
                    get = lambda k, d: float(q.get(k, [d])[0])
                    if q.get("mode", ["orbit"])[0] == "fly":
                        c2w = _fly_c2w(
                            np.array([get("px", 0), get("py", -2),
                                      get("pz", -10)]),
                            get("yaw", 0), get("pitch", 0))
                    else:
                        c2w = _orbit_c2w(get("az", 0), get("el", 15),
                                         get("dist", 25))
                    png = mgr._render_png(c2w, int(get("frame", 0)),
                                          q.get("preview", ["0"])[0] == "1")
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(png)
                    return
                self.send_response(404)
                self.end_headers()

        self.server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        t = threading.Thread(target=self.server.serve_forever, daemon=True)
        t.start()
        print(f"[viewer] http://localhost:{port}")

    def _render_png(self, c2w, frame, preview=False) -> bytes:
        from PIL import Image
        with self.lock:                       # share the chip with training
            # [3, H, W] float in [0,1]; preview asks the callback for its
            # reduced-resolution render (nerfview's while-moving
            # degradation) — two-parameter callbacks render full
            # resolution always
            if self._fn_takes_preview:
                img = self.render_fn(c2w, frame, preview)
            else:
                img = self.render_fn(c2w, frame)
        arr = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr.transpose(1, 2, 0)).save(buf, format="PNG")
        return buf.getvalue()


def _orbit_c2w(az_deg, el_deg, dist):
    az, el = np.deg2rad(az_deg), np.deg2rad(el_deg)
    cam = dist * np.array([np.cos(el) * np.sin(az), -np.sin(el),
                           np.cos(el) * np.cos(az)])
    fwd = -cam / (np.linalg.norm(cam) + 1e-9)
    return _look_c2w(cam, fwd)


def _fly_c2w(pos, yaw_deg, pitch_deg):
    """Free-perspective pose from position + yaw/pitch (y points down,
    matching the LiDAR frame used throughout)."""
    y, p = np.deg2rad(yaw_deg), np.deg2rad(pitch_deg)
    fwd = np.array([np.cos(p) * np.sin(y), -np.sin(p),
                    np.cos(p) * np.cos(y)])
    return _look_c2w(pos, fwd)


def _look_c2w(cam, fwd):
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right) + 1e-9
    up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, fwd, cam
    return c2w
