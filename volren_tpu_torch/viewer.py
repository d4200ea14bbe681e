"""Headless interactive viewer: a localhost HTTP front-end (the port of
volren_tpu.viewer; frames are encoded by ``utils.image.encode_png``).

The reference's interactive layer is a live GL window plus an ImGui panel
exposing every render parameter and a mouse/keyboard camera
(reference src/main.cpp:164-305,477-523). In this framework the
display surface is a browser tab on localhost: the CLI's interactive loop
keeps tracing progressively, and this server publishes the live frame and
the parameter panel over HTTP.

Endpoints:
  GET /            HTML page: auto-refreshing frame + live parameter table
                   + an edit form (the ImGui-panel analogue) + WASD/mouse
                   camera controls (the cppgl default_input_handler
                   analogue, reference README "WASD/RFEQ/mouse")
  GET /frame.png   current tonemapped framebuffer as PNG
  GET /state.json  Renderer.describe() as JSON
  GET /set?k=v     set a parameter (same names as describe()/CLI flags)
                   and reset accumulation — mirrors how every ImGui edit
                   calls reset() in the reference
  GET /nav?fwd=&right=&up=   translate the camera in view space (WASD/RF)
  GET /look?dx=&dy=          rotate the view direction (mouse drag)
  GET /snapshot    request one full-resolution render (the serve loop
                   renders at preview resolution by default; see cli.py)

Parameter edits mutate the renderer from the server thread while the
render loop owns tracing; a lock serializes access so a trace step never
interleaves with a half-applied edit.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

import numpy as np

from .utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>volren_tpu_torch</title>
<style>
 body {{ font-family: monospace; background: #111; color: #ddd; margin: 1em; }}
 img {{ image-rendering: pixelated; border: 1px solid #444; max-width: 60vw; }}
 table {{ border-collapse: collapse; }}
 td {{ padding: 1px 8px; }}
 .row {{ display: flex; gap: 2em; align-items: flex-start; }}
 input {{ background: #222; color: #ddd; border: 1px solid #555; }}
</style></head>
<body>
<h3>volren_tpu_torch live view</h3>
<p>click the frame, then WASD move / RF up-down / drag to look
 (shift = 10x) — <button onclick="fetch('/snapshot')">full-res snapshot</button></p>
<div class="row">
 <img id="frame" src="/frame.png" alt="frame" tabindex="0"/>
 <div>
  <table id="params"></table>
  <form onsubmit="return setParam(this)">
   <input name="k" placeholder="param"/> = <input name="v" placeholder="value"/>
   <input type="submit" value="set"/>
  </form>
 </div>
</div>
<script>
 async function tick() {{
   document.getElementById('frame').src = '/frame.png?' + Date.now();
   const s = await (await fetch('/state.json')).json();
   document.getElementById('params').innerHTML = Object.entries(s)
     .map(([k, v]) => `<tr><td>${{k}}</td><td>${{JSON.stringify(v)}}</td></tr>`)
     .join('');
 }}
 function setParam(f) {{
   fetch(`/set?${{encodeURIComponent(f.k.value)}}=${{encodeURIComponent(f.v.value)}}`);
   return false;
 }}
 const img = document.getElementById('frame');
 const KEYS = {{w:[1,0,0], s:[-1,0,0], d:[0,1,0], a:[0,-1,0],
               r:[0,0,1], f:[0,0,-1]}};
 img.addEventListener('keydown', e => {{
   const m = KEYS[e.key.toLowerCase()];
   if (!m) return;
   const sc = e.shiftKey ? 10 : 1;
   fetch(`/nav?fwd=${{m[0]*sc}}&right=${{m[1]*sc}}&up=${{m[2]*sc}}`);
   e.preventDefault();
 }});
 let drag = null;
 img.addEventListener('mousedown', e => {{ drag = [e.clientX, e.clientY]; }});
 window.addEventListener('mouseup', () => {{ drag = null; }});
 window.addEventListener('mousemove', e => {{
   if (!drag) return;
   const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
   drag = [e.clientX, e.clientY];
   if (dx || dy) fetch(`/look?dx=${{dx}}&dy=${{dy}}`);
 }});
 img.addEventListener('dragstart', e => e.preventDefault());
 setInterval(tick, 1000); tick();
</script>
</body></html>
"""

# parameters editable over /set — scalar fields forwarded verbatim plus
# vector fields parsed as comma-separated floats
_SCALARS = {
    "sppx": int,
    "seed": int,
    "bounces": int,
    "tonemap_exposure": float,
    "tonemap_gamma": float,
    "tonemapping": lambda v: v not in ("0", "false", "False"),
    "show_environment": lambda v: v not in ("0", "false", "False"),
    "phase": float,
    "density_scale": float,
    "emission_scale": float,
}
_VECTORS = {"albedo", "vol_clip_min", "vol_clip_max", "cam_pos", "cam_dir"}


def _rotate(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation of v around a unit axis."""
    c, s = np.cos(angle), np.sin(angle)
    return (
        v * c + np.cross(axis, v) * s + axis * float(axis @ v) * (1.0 - c)
    ).astype(np.float32)


class ViewerServer:
    """Owns the HTTP server thread; share `lock` with the render loop."""

    def __init__(self, renderer, port: int = 0, host: str = "127.0.0.1"):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.snapshot_requested = False  # polled by the cli serve loop
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/":
                        self._send(200, "text/html", _PAGE.encode())
                    elif url.path == "/frame.png":
                        self._send(200, "image/png", viewer.frame_png())
                    elif url.path == "/state.json":
                        with viewer.lock:
                            state = viewer.renderer.describe()
                        self._send(200, "application/json", json.dumps(state).encode())
                    elif url.path == "/set":
                        applied = viewer.apply_params(dict(parse_qsl(url.query)))
                        self._send(200, "application/json", json.dumps(applied).encode())
                    elif url.path == "/nav":
                        q = dict(parse_qsl(url.query))
                        viewer.navigate(
                            float(q.get("fwd", 0)), float(q.get("right", 0)),
                            float(q.get("up", 0)),
                        )
                        self._send(200, "application/json", b"{}")
                    elif url.path == "/look":
                        q = dict(parse_qsl(url.query))
                        viewer.look(float(q.get("dx", 0)), float(q.get("dy", 0)))
                        self._send(200, "application/json", b"{}")
                    elif url.path == "/snapshot":
                        viewer.snapshot_requested = True
                        self._send(200, "application/json", b'{"snapshot": true}')
                    else:
                        self._send(404, "text/plain", b"not found")
                except Exception as e:  # never kill the render loop
                    self._send(500, "text/plain", str(e).encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "ViewerServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def frame_png(self) -> bytes:
        with self.lock:
            frame = self.renderer.draw()
        arr = np.clip(np.asarray(frame)[..., :3] * 255.0, 0, 255).astype(np.uint8)
        return encode_png(arr[::-1])

    # --- camera controls (cppgl default_input_handler analogue: WASD move,
    # RF up/down, mouse-drag look; the reference scales speed by frame time,
    # here one step = 5% of the unit-cube scene per event)
    _NAV_STEP = 0.05
    _LOOK_RAD_PER_PX = 0.005

    def navigate(self, fwd: float, right: float, up: float) -> None:
        with self.lock:
            cam = self.renderer.cam
            d = np.asarray(cam.dir, np.float32)
            u = np.asarray(cam.up, np.float32)
            r = np.cross(d, u)
            r /= max(np.linalg.norm(r), 1e-8)
            cam.pos = np.asarray(cam.pos, np.float32) + self._NAV_STEP * (
                fwd * d + right * r + up * u
            )
            self.renderer.reset()

    def look(self, dx: float, dy: float) -> None:
        """Yaw around up, pitch around the view-right axis (clamped so dir
        never crosses the up pole)."""
        with self.lock:
            cam = self.renderer.cam
            d = np.asarray(cam.dir, np.float32)
            u = np.asarray(cam.up, np.float32)
            u = u / max(np.linalg.norm(u), 1e-8)
            yaw = -dx * self._LOOK_RAD_PER_PX
            pitch = -dy * self._LOOK_RAD_PER_PX
            d = _rotate(d, u, yaw)
            r = np.cross(d, u)
            r /= max(np.linalg.norm(r), 1e-8)
            nd = _rotate(d, r, pitch)
            if abs(float(nd @ u)) < 0.99:  # keep away from the pole
                d = nd
            cam.dir = d / max(np.linalg.norm(d), 1e-8)
            self.renderer.reset()

    def apply_params(self, params: dict) -> dict:
        """Set parameters by describe()/CLI name; any edit resets
        accumulation (reference: every ImGui change calls reset())."""
        applied = {}
        with self.lock:
            for k, v in params.items():
                if k in _SCALARS:
                    setattr(self.renderer, k, _SCALARS[k](v))
                elif k in _VECTORS:
                    vec = np.asarray([float(x) for x in v.split(",")], np.float32)
                    if k.startswith("cam_"):
                        if k == "cam_dir":
                            vec = vec / np.linalg.norm(vec)
                        setattr(self.renderer.cam, k[4:], vec)
                    else:
                        setattr(self.renderer, k, vec)
                else:
                    continue
                applied[k] = v
            if applied:
                self.renderer.reset()
        return applied
