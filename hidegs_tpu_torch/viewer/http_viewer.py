"""Interactive HTTP viewer: a browser frontend with no dependencies.

Port of hidegs_tpu/viewer/http_viewer.py. The reference ships the SIBR
OpenGL application (SURVEY §2.1 row 12), which network_gui.py serves at the
wire-protocol level; this module is a stdlib http.server that renders
orbit-camera frames on demand, with a small HTML page of drag/scroll
controls. Frames are PNGs from utils/png.py (no Pillow).

  python -m hidegs_tpu_torch.viewer --model_path /out/run1 --http 8080

Endpoints:
  GET /                 controls page (drag = orbit, wheel = dolly,
                        shift-drag = pan)
  GET /frame?yaw&pitch&dist&cx&cy&cz&w&h   rendered PNG
  GET /info             scene summary JSON

Rendering is serialised with a lock (one device); frames are keyed by the
rounded camera, so repeated requests hit a small LRU instead of the card.
"""
from __future__ import annotations

import json
import threading
import urllib.parse
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

from hidegs_tpu_torch.core.camera_math import CameraParams, make_camera
from hidegs_tpu_torch.device import DeviceLike, resolve_device
from hidegs_tpu_torch.utils.png import encode_png
from hidegs_tpu_torch.viewer.network_gui import image_bytes

_PAGE = """<!doctype html>
<html><head><title>hidegs_tpu viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:8px; background:#0008; padding:6px 10px;
        border-radius:6px; }
 img  { display:block; margin:auto; image-rendering:auto; cursor:grab; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: dolly &middot; shift-drag: pan</div>
<img id="v" width=WIDTH height=HEIGHT>
<script>
let yaw=0.6, pitch=0.9, dist=DIST, cx=CX, cy=CY, cz=CZ, busy=false, queued=false;
const img=document.getElementById('v');
function url(){return `/frame?yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}`+
  `&dist=${dist.toFixed(3)}&cx=${cx.toFixed(2)}&cy=${cy.toFixed(2)}&cz=${cz.toFixed(2)}`+
  `&w=WIDTH&h=HEIGHT`;}
function refresh(){ if(busy){queued=true;return;} busy=true;
  const u=url(); const probe=new Image();
  probe.onload=()=>{img.src=u; busy=false; if(queued){queued=false;refresh();}};
  probe.onerror=()=>{busy=false;};
  probe.src=u; }
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){ const s=dist*0.002;
    cx-=s*(dx*Math.cos(yaw)); cy-=s*(dx*Math.sin(yaw)); cz+=s*dy; }
  else { yaw-=dx*0.008; pitch=Math.min(1.55,Math.max(0.05,pitch-dy*0.008)); }
  drag=[e.clientX,e.clientY,drag[2]]; refresh(); };
img.onwheel=e=>{ dist*=Math.exp(e.deltaY*0.001); e.preventDefault(); refresh(); };
refresh();
</script></body></html>"""


def orbit_camera(
    yaw: float, pitch: float, dist: float, center, height: int, width: int,
    focal: float = None, device: DeviceLike = "cuda",
) -> CameraParams:
    """Spherical orbit around `center` (+z up), looking at it."""
    if focal is None:
        focal = 0.9 * max(height, width)
    c = np.asarray(center, np.float64)
    pos = c + dist * np.array(
        [np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch), np.sin(pitch)]
    )
    fwd = c - pos
    fwd /= np.linalg.norm(fwd)
    up_hint = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up_hint)
    n = np.linalg.norm(right)
    if n < 1e-6:  # looking straight down: pick any horizontal right axis
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= n
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    t = -R @ pos
    return make_camera(R, t, fx=focal, fy=focal, height=height, width=width, device=device)


class HttpViewer:
    """render_fn(cam: CameraParams) -> (3, H, W) float image in [0, 1]; the
    cameras are made on `device`."""

    def __init__(
        self,
        render_fn: Callable[[CameraParams], object],
        center=(0.0, 0.0, 0.0),
        dist: float = 10.0,
        host: str = "0.0.0.0",
        port: int = 8080,
        width: int = 640,
        height: int = 480,
        info: dict = None,
        cache_frames: int = 32,
        device: DeviceLike = "cuda",
    ):
        self.render_fn = render_fn
        self.device = resolve_device(device)
        self.center = tuple(float(x) for x in center)
        self.dist = float(dist)
        self.size = (width, height)
        self.info = dict(info or {})
        self._lock = threading.Lock()
        self._cache: OrderedDict = OrderedDict()
        self._cache_frames = cache_frames
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    parsed = urllib.parse.urlparse(self.path)
                    if parsed.path == "/":
                        w, h = viewer.size
                        cx, cy, cz = viewer.center
                        page = (
                            _PAGE.replace("WIDTH", str(w)).replace("HEIGHT", str(h))
                            .replace("DIST", f"{viewer.dist:.2f}")
                            .replace("CX", f"{cx:.2f}").replace("CY", f"{cy:.2f}")
                            .replace("CZ", f"{cz:.2f}")
                        )
                        self._send(200, "text/html", page.encode())
                    elif parsed.path == "/info":
                        self._send(200, "application/json", json.dumps(viewer.info).encode())
                    elif parsed.path == "/frame":
                        q = urllib.parse.parse_qs(parsed.query)
                        g = lambda k, d: float(q.get(k, [d])[0])  # noqa: E731
                        # clamp the client's size: an arbitrary w/h would ask
                        # for a huge device allocation, and 0 or less errors
                        cw = min(max(int(g("w", viewer.size[0])), 16), 2048)
                        ch = min(max(int(g("h", viewer.size[1])), 16), 2048)
                        png = viewer.frame_png(
                            g("yaw", 0.6), g("pitch", 0.9), g("dist", viewer.dist),
                            (g("cx", viewer.center[0]), g("cy", viewer.center[1]),
                             g("cz", viewer.center[2])),
                            cw, ch,
                        )
                        self._send(200, "image/png", png)
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface render errors to the client
                    self._send(500, "text/plain", str(e).encode())

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]

    def frame_png(self, yaw, pitch, dist, center, w, h) -> bytes:
        key = (round(yaw, 3), round(pitch, 3), round(dist, 3),
               tuple(round(c, 2) for c in center), w, h)
        with self._lock:  # one device; render and cache under the same lock
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
            cam = orbit_camera(yaw, pitch, dist, center, h, w, device=self.device)
            png = encode_png(image_bytes(self.render_fn(cam)))
            self._cache[key] = png
            while len(self._cache) > self._cache_frames:
                self._cache.popitem(last=False)
            return png

    def serve_forever(self):
        self._server.serve_forever()

    def serve_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
