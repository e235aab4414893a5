"""Browser viewer: an orbit camera and live renders over HTTP (port of
texgs/tools/viewer.py).

A small HTTP server serves an HTML5 canvas page (drag = orbit, wheel =
dolly, buttons for the render mode rgb / depth / alpha / normal, sliders
for the scaling modifier and the field of view) and ``/frame``, one PNG
render of the model for the camera the query names.

    python -m texgs_torch.tools.viewer <config> --ckpt CKPT [--port 8000]
        [--width 640] [--height 480] [--load_texture_from PNG] [--mode 0]
        [--device cuda|cpu]

It renders on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import inspect
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html><html><head><title>texgs viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:10px}
canvas{border:1px solid #444;cursor:grab}button{margin:2px}
</style></head><body>
<div>
  <button onclick="setMode('rgb')">rgb</button>
  <button onclick="setMode('depth')">depth</button>
  <button onclick="setMode('alpha')">alpha</button>
  <button onclick="setMode('norm')">normal</button>
  scale <input id="scale" type="range" min="0.1" max="2.0" step="0.1"
    value="1.0" onchange="refresh()">
  fov <input id="fov" type="range" min="20" max="120" step="1"
    value="50" onchange="refresh()">
  <button onclick="screenshot()">screenshot</button>
  <span id="stat"></span>
</div>
<canvas id="c" width="{W}" height="{H}"></canvas>
<script>
let az=0, el=0.3, r=3.5, mode='rgb', drag=false, lx=0, ly=0, busy=false;
const c=document.getElementById('c'), ctx=c.getContext('2d');
c.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;az+=(e.clientX-lx)*0.01;
  el=Math.max(-1.4,Math.min(1.4,el+(e.clientY-ly)*0.01));
  lx=e.clientX;ly=e.clientY;refresh();};
c.onwheel=e=>{e.preventDefault();r=Math.max(0.5,r+e.deltaY*0.002);refresh();};
function setMode(m){mode=m;refresh();}
function screenshot(){
  const a=document.createElement('a');
  a.download='texgs_'+Date.now()+'.png';
  a.href=c.toDataURL('image/png'); a.click();}
async function refresh(){
  if(busy)return; busy=true;
  const s=document.getElementById('scale').value;
  const f=document.getElementById('fov').value;
  const t0=performance.now();
  const img=new Image();
  img.onload=()=>{ctx.drawImage(img,0,0);busy=false;
    document.getElementById('stat').textContent=
      ' '+(performance.now()-t0).toFixed(0)+'ms';};
  img.src=`/frame?az=${az}&el=${el}&r=${r}&mode=${mode}&scale=${s}&fov=${f}&t=${Date.now()}`;
}
refresh();
</script></body></html>"""


class ViewerState:
    """The model and the frame size; renders one frame at a time."""

    def __init__(self, model, width: int, height: int, fov_deg: float = 50.0):
        self.model = model
        self.width = width
        self.height = height
        self.fov_deg = fov_deg
        self.lock = threading.Lock()

    def render_frame(self, az: float, el: float, radius: float, mode: str,
                     scale: float, fov_deg: float = None) -> np.ndarray:
        """(H, W, 3) uint8 frame from the orbit camera at azimuth ``az``,
        elevation ``el`` and distance ``radius`` looking at the origin; the
        field of view is rounded to whole degrees as texgs's is.  ``scale``
        is the scaling modifier of models whose ``visual_step`` takes one
        (stage 1); the stage-3 render has none."""
        import torch

        from texgs_torch.core.camera import look_at_camera

        eye = np.array([radius * math.cos(az) * math.cos(el),
                        radius * math.sin(az) * math.cos(el),
                        radius * math.sin(el)])
        fovx = math.radians(round(fov_deg if fov_deg else self.fov_deg))
        fovy = 2 * math.atan(math.tan(fovx / 2) * self.height / self.width)
        cam = look_at_camera(eye, np.zeros(3), np.array([0.0, 0.0, 1.0]),
                             fovx, fovy, self.width, self.height)
        params = inspect.signature(self.model.visual_step).parameters
        kw = {"scaling_modifier": scale} if "scaling_modifier" in params else {}
        with self.lock, torch.no_grad():
            pkg = self.model.visual_step(0, 0, cam, None, **kw)
            if mode == "depth":
                d = pkg["depth"][0].cpu().numpy()
                a = pkg["alpha"][0].cpu().numpy() > 0.5
                if a.any():
                    lo, hi = d[a].min(), d[a].max()
                    d = np.where(a, (d - lo) / (hi - lo + 1e-8), 0)
                img = np.stack([d] * 3, -1)
            elif mode == "alpha":
                img = np.stack([pkg["alpha"][0].cpu().numpy()] * 3, -1)
            elif mode == "norm":
                img = 0.5 * (pkg["norm"].cpu().numpy().transpose(1, 2, 0) + 1)
            else:
                img = pkg["image"].cpu().numpy().transpose(1, 2, 0)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_server(state: ViewerState, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """The viewer's HTTP server on (host, port), not yet serving: ``/``
    is the page, ``/frame`` one PNG frame."""
    from texgs_torch.io import png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(_PAGE.replace("{W}", str(state.width))
                           .replace("{H}", str(state.height)).encode(),
                           "text/html")
            elif u.path == "/frame":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                frame = state.render_frame(
                    float(q.get("az", 0)), float(q.get("el", 0.3)),
                    float(q.get("r", 3.5)), q.get("mode", "rgb"),
                    float(q.get("scale", 1.0)),
                    float(q.get("fov", 0)) or None)
                self._send(png.encode(frame), "image/png")
            else:
                self.send_response(404)
                self.end_headers()

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    from argparse import ArgumentParser

    from texgs_torch.config import load_config
    from texgs_torch.io import png
    from texgs_torch.train.models import load_model

    parser = ArgumentParser(description="texgs_torch browser viewer")
    parser.add_argument("config")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--load_texture_from", type=str, default=None)
    parser.add_argument("--mode", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    model = load_model(cfg, args.ckpt, args.device)[0]
    if args.load_texture_from and cfg.model_cfg.type == "TextureGaussian3D":
        img = png.read(args.load_texture_from)[..., :3]
        model.change_texture(img.astype(np.float32) / 255.0, mode=args.mode)
    server = make_server(ViewerState(model, args.width, args.height),
                         port=args.port)
    print(f"texgs_torch viewer at http://localhost:{args.port}/", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
