"""Interactive browser viewer on the port's generators.

Port of the JAX package's ``tools/viewer.py``: a stdlib HTTP server drives
the port's generators in-process and the page renders their frames on HTML
canvases (range-image colour map and a bird's-eye scatter), with no GUI
toolkit, display or external JavaScript.  Layout-conditioned configs take
interactively edited boxes ([[x, y, z, l, w, h, yaw, class], ...]), which
are rasterised on the device into the concat-condition mask
(``ops/projection.py::convert_boxes_to_2d``).  The routes and their JSON
are the JAX viewer's: ``GET /`` (the page) and ``POST /api/sample``
(``{config, steps, mode, seed, boxes}`` → ``{depth, reflectance, points,
restored_checkpoint}``; 500 with the reason as text on a bad request).  It
runs on the card unless ``--device cpu``.

Usage::

  python -m lidarcrafter_tpu_torch.viewer [--port 8400] [--ckpt-root DIR] [--resolution H W] [--device cuda]

``--ckpt-root DIR`` serves ``DIR/<config>`` (one of the port's training
checkpoints; its EMA weights) per config; without it the generators run
with seeded random weights.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .configs import apply_reduced_topology, get_config
from .generate import UncondFrameGenerator
from .generate_cond import CondFrameGenerator
from .generate_flow import FlowFrameGenerator
from .ops.projection import convert_boxes_to_2d
from .training.factory import layout_condition_batch
from .training.preprocess import postprocess_sample, preprocess_condition_mask

UNCOND = ("nuscenes-unet-uncond",)
FLOW = ("meanflow-nusc",)
COND = ("nuscenes-box-layout-v6", "nuscenes-auto-reg-v2")
CONFIGS = UNCOND + FLOW + COND


class SamplerHub:
    """Builds and caches one generator per config name on ``device``."""

    def __init__(self, ckpt_root=None, resolution=None, device: str | torch.device = "cuda",
                 model_channels: int | None = None):
        self.ckpt_root = ckpt_root
        self.resolution = resolution
        self.model_channels = model_channels
        self.device = resolve_device(device)
        self._cache = {}
        # a build lock per config: building one config must not block the
        # requests for configs that are already built
        self._lock = threading.Lock()
        self._build_locks = {}

    def _ckpt(self, name) -> str | None:
        if not self.ckpt_root:
            return None
        ckpt = Path(self.ckpt_root) / name
        return str(ckpt) if ckpt.exists() else None

    def _build(self, name) -> dict:
        cfg = apply_reduced_topology(get_config(name), resolution=self.resolution,
                                     model_channels=self.model_channels)
        ckpt = self._ckpt(name)
        if name in FLOW:
            gen, kind = FlowFrameGenerator(cfg, device=self.device, ckpt=ckpt, ema=True), "flow"
        elif name in COND:
            gen, kind = CondFrameGenerator(cfg, device=self.device, ckpt=ckpt), "cond"
        else:
            gen, kind = UncondFrameGenerator(cfg, device=self.device, ckpt=ckpt), "uncond"
        return dict(cfg=cfg, gen=gen, kind=kind, restored=ckpt is not None)

    @staticmethod
    def cond_batch(cfg, boxes, lidar_utils, device) -> dict:
        """The one-frame condition batch; ``boxes`` ((N, 8) list or None)
        are rasterised into the concat mask as the dataset does."""
        batch = layout_condition_batch(cfg, 1, device=device)
        cc = cfg.condition_model.params.get("out_channels", 0)
        if not cc:
            return batch
        H, W = cfg.data.resolution
        L = cfg.condition_model.params["layout_length"]
        if boxes:
            arr = np.zeros((L, 8), np.float32)
            n = min(len(boxes), L)
            arr[:n] = np.asarray(boxes, np.float32)[:n, :8]
            _, cmask, _ = convert_boxes_to_2d(torch.as_tensor(arr, device=device),
                                              torch.as_tensor(np.arange(L) < n, device=device), H=H, W=W)
        else:
            cmask = torch.zeros((H, W, 2), device=device)
        concat = preprocess_condition_mask({"condition_mask": cmask[None]}, lidar_utils, len(cfg.data.class_names))
        if "autoregressive_cond" in batch:
            batch["concat_cond"] = concat[..., :cc - 1]
        else:
            batch["concat_cond"] = concat
        return batch

    def get(self, name) -> dict:
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            build_lock = self._build_locks.setdefault(name, threading.Lock())
        with build_lock:
            with self._lock:
                if name in self._cache:
                    return self._cache[name]
            entry = self._build(name)
            with self._lock:
                self._cache[name] = entry
            return entry

    def sample(self, name, num_steps=8, mode="ddim", seed=0, boxes=None) -> dict:
        entry = self.get(name)
        gen = entry["gen"]
        if entry["kind"] == "flow":
            generator = torch.Generator(device=gen.device).manual_seed(int(seed))
            post = postprocess_sample(gen.engine.sample(1, generator=generator), gen.lidar_utils)
        elif entry["kind"] == "cond":
            batch = self.cond_batch(entry["cfg"], boxes, gen.lidar_utils, gen.device)
            _, post = gen.generate(1, int(num_steps), mode=mode, seed=int(seed), batch=batch)
        else:
            _, post = gen.generate(1, int(num_steps), mode=mode, seed=int(seed))
        depth = post["depth"][0, ..., 0].cpu().numpy()
        refl = post["reflectance"][0, ..., 0].cpu().numpy()
        xyz = post["xyz"][0].reshape(-1, 3).cpu().numpy()
        xyz = xyz[np.linalg.norm(xyz, axis=1) > 1e-2][:16384]
        return {
            "depth": np.round(depth, 3).tolist(),
            "reflectance": np.round(refl, 3).tolist(),
            "points": np.round(xyz, 2).tolist(),
            "restored_checkpoint": bool(entry["restored"]),
        }


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>lidarcrafter-tpu viewer</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.2rem;background:#14161a;color:#e6e6e6}
 canvas{background:#000;display:block;margin:.4rem 0;border:1px solid #333}
 select,input,button,textarea{background:#22252b;color:#e6e6e6;border:1px solid #444;
   padding:.3rem .5rem;margin-right:.5rem}
 button{cursor:pointer} #status{color:#8fb6ff} .row{margin:.5rem 0}
 textarea{width:46rem;height:4rem;vertical-align:top}
</style></head><body>
<h2>lidarcrafter-tpu viewer</h2>
<div class="row">
 <select id="config">__OPTIONS__</select>
 steps <input id="steps" type="number" value="8" min="1" style="width:4rem">
 <select id="mode"><option>ddim</option><option>ddpm</option></select>
 seed <input id="seed" type="number" value="0" style="width:4rem">
 <button id="go">Generate</button> <span id="status"></span>
</div>
<div class="row">layout boxes (conditional configs) [[x,y,z,l,w,h,yaw,class],…]:<br>
 <textarea id="boxes">[[10,3,-0.5,4.5,2,1.7,0.3,1],[18,-6,-0.4,4.2,1.9,1.6,-1.2,1]]</textarea>
</div>
<div>range depth <canvas id="depth"></canvas></div>
<div>reflectance <canvas id="refl"></canvas></div>
<div>BEV (&plusmn;50 m) <canvas id="bev" width="560" height="560"></canvas></div>
<script>
function turbo(t){t=Math.max(0,Math.min(1,t));
 return [Math.round(255*Math.min(1,Math.max(0,34.61+t*(1172.33-t*(10793.56-t*(33300.12-t*(38394.49-t*14825.05))))/255))),
         Math.round(255*Math.min(1,Math.max(0,23.31+t*(557.33+t*(1225.33-t*(3574.96-t*(1073.77+t*707.56))))/255))),
         Math.round(255*Math.min(1,Math.max(0,27.2+t*(3211.1-t*(15327.97-t*(27814-t*(22569.18-t*6838.66))))/255)))];}
function drawImg(id, rows, maxv){const H=rows.length,W=rows[0].length;
 const c=document.getElementById(id);c.width=W;c.height=H;
 c.style.width='100%';c.style.imageRendering='pixelated';
 const g=c.getContext('2d'),im=g.createImageData(W,H);
 for(let i=0;i<H;i++)for(let j=0;j<W;j++){const v=rows[i][j]/maxv;
  const [r,gg,b]=turbo(v);const o=4*(i*W+j);
  im.data[o]=r;im.data[o+1]=gg;im.data[o+2]=b;im.data[o+3]=255;}
 g.putImageData(im,0,0);}
function drawBEV(pts){const c=document.getElementById('bev'),g=c.getContext('2d');
 g.fillStyle='#000';g.fillRect(0,0,c.width,c.height);
 const s=c.width/100.0;
 for(const p of pts){const x=c.width/2+p[0]*s,y=c.height/2-p[1]*s;
  if(x<0||y<0||x>=c.width||y>=c.height)continue;
  const t=Math.max(0,Math.min(1,(p[2]+3)/6));const [r,gg,b]=turbo(t);
  g.fillStyle=`rgb(${r},${gg},${b})`;g.fillRect(x,y,1.6,1.6);}}
document.getElementById('go').onclick=async()=>{
 const st=document.getElementById('status');st.textContent='sampling…';
 let boxes=null;
 try{boxes=JSON.parse(document.getElementById('boxes').value);}catch(e){boxes=null;}
 const body={config:document.getElementById('config').value,
  steps:+document.getElementById('steps').value,
  mode:document.getElementById('mode').value,
  seed:+document.getElementById('seed').value, boxes:boxes};
 try{
  const r=await fetch('/api/sample',{method:'POST',body:JSON.stringify(body)});
  if(!r.ok){st.textContent='error: '+await r.text();return;}
  const d=await r.json();
  drawImg('depth',d.depth,80.0);drawImg('refl',d.reflectance,1.0);
  drawBEV(d.points);
  st.textContent=(d.restored_checkpoint?'checkpoint weights':'random init')+
   ' · '+d.points.length+' points';
 }catch(e){st.textContent='error: '+e;}
};
</script></body></html>"""


def make_handler(hub):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                opts = "".join(f"<option>{c}</option>" for c in CONFIGS)
                self._send(200, _PAGE.replace("__OPTIONS__", opts),
                           "text/html; charset=utf-8")
            else:
                self._send(404, "not found", "text/plain")

        def do_POST(self):
            if self.path != "/api/sample":
                self._send(404, "not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                name = req.get("config", CONFIGS[0])
                if name not in CONFIGS:
                    raise ValueError(f"unknown config {name!r}")
                out = hub.sample(
                    name,
                    num_steps=req.get("steps", 8),
                    mode=req.get("mode", "ddim"),
                    seed=req.get("seed", 0),
                    boxes=req.get("boxes"),
                )
                self._send(200, json.dumps(out))
            except Exception as e:  # surface the reason to the page
                self._send(500, f"{type(e).__name__}: {e}", "text/plain")

    return Handler


def serve(port=8400, host="127.0.0.1", ckpt_root=None, resolution=None, device="cuda", model_channels=None):
    """A server (not yet serving) of a new :class:`SamplerHub`; port 0
    binds a free port (``httpd.server_address``)."""
    hub = SamplerHub(ckpt_root=ckpt_root, resolution=resolution, device=device, model_channels=model_channels)
    return ThreadingHTTPServer((host, port), make_handler(hub))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=8400)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--ckpt-root", default=None)
    ap.add_argument("--resolution", type=int, nargs=2, default=None, help="override H W (smoke runs)")
    ap.add_argument("--model-channels", type=int, default=None, help="override widths (smoke runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    httpd = serve(args.port, args.host, args.ckpt_root, args.resolution, args.device, args.model_channels)
    print(f"viewer on http://{args.host}:{httpd.server_address[1]}  (configs: {', '.join(CONFIGS)})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
