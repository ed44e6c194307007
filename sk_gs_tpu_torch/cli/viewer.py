"""The interactive viewer (port of the JAX package's root ``viewer.py``):
a standard-library HTTP server that renders the model at the browser's
camera, time and pose and streams PNG frames to a canvas page (orbit =
drag, zoom = wheel, time slider, per-joint pose sliders, skeleton
overlay, click to pick a superpoint).

    python -m sk_gs_tpu_torch.cli.viewer -c <config.yaml> --load <ckpt.npz>
        [--port 8090] [--host 127.0.0.1] [--stage sk] [--set ...]
        [--device cuda]

Routes, parameters, status codes and JSON keys are the JAX viewer's:
``/`` (the page), ``/info``, ``/render?theta&phi&radius&t&mode&pose&sel``
(``mode`` 'rgb', 'opacity' or 'superpoints'; PNG), ``/pick?...&x&y`` (the
dominant superpoint under a pixel, from the per-pixel top-8 blend
weights of ``render.render_topk``) and ``/skeleton?...`` (the joints
projected to the image and the bones between live ones). The pose
sliders' rotations are ``sk_r_delta`` in the ``sk`` and ``sk_fix``
stages. One lock serialises the device; requests run under
``torch.inference_mode()``. The model is loaded as ``cli.test`` loads it,
from a port checkpoint or a JAX one, at the checkpoint's capacity. It
runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .. import resolve_device
from ..convert import model_from_flat
from ..framework import build
from ..framework.checkpoint import capacity_of, load
from ..framework.config import make_config
from ..models.gaussian_splatting import gaussian_inputs
from ..models.sk_gs import forward_deltas
from ..ops.se3 import se3_act
from ..ops.transforms import look_at
from ..render.render import composite_background, render, render_topk
from ..utils.png import encode_png, to_uint8

log = logging.getLogger('sk_gs_tpu_torch.viewer')
MODES = ('rgb', 'superpoints', 'opacity')
PICK_K = 8

PAGE = """<!DOCTYPE html>
<html><head><title>sk_gs_tpu viewer</title><style>
body{font-family:sans-serif;margin:12px;background:#1e1e1e;color:#ddd}
#wrap{display:flex;gap:16px}
canvas{border:1px solid #555;cursor:grab}
.panel{min-width:260px}
label{display:block;margin-top:8px;font-size:13px}
input[type=range]{width:220px}
select,button{margin-top:4px}
#status{margin-top:10px;font-size:12px;color:#9a9}
</style></head><body>
<h3>sk_gs_tpu viewer</h3>
<div id=wrap>
<div><canvas id=cv width=512 height=512></canvas></div>
<div class=panel>
 <label>time <span id=tv>0.00</span>
  <input type=range id=time min=0 max=1 step=0.01 value=0></label>
 <label>mode
  <select id=mode><option>rgb</option><option>superpoints</option>
  <option>opacity</option></select></label>
 <label><input type=checkbox id=skel> skeleton overlay</label>
 <label>joint <select id=joint></select></label>
 <label>rot x <span id=jx>0</span>
  <input type=range id=rx min=-3.14 max=3.14 step=0.02 value=0></label>
 <label>rot y <span id=jy>0</span>
  <input type=range id=ry min=-3.14 max=3.14 step=0.02 value=0></label>
 <label>rot z <span id=jz>0</span>
  <input type=range id=rz min=-3.14 max=3.14 step=0.02 value=0></label>
 <button id=resetpose>reset pose</button>
 <button id=resetcam>reset camera</button>
 <div id=status>loading…</div>
</div></div>
<script>
let info=null, theta=0, phi=0.3, radius=4, pose={}, busy=false, dirty=true;
let sel=-1;
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
const $=id=>document.getElementById(id);
async function init(){
  info=await (await fetch('info')).json();
  radius=info.radius;
  const sel=$('joint');
  for(let i=0;i<info.num_joints;i++){
    const o=document.createElement('option');o.text=i;sel.add(o);}
  sel.onchange=()=>{const d=pose[sel.value]||[0,0,0];
    $('rx').value=d[0];$('ry').value=d[1];$('rz').value=d[2];};
  $('status').textContent=`stage=${info.stage} joints=${info.num_joints} `+
    `superpoints=${info.num_superpoints} ${info.width}x${info.height}`;
  loop();
}
function poseCSV(){
  const out=[];
  for(let i=0;i<info.num_joints;i++){
    const d=pose[i]||[0,0,0]; out.push(d.join(','));}
  return out.join(';');
}
async function draw(){
  if(busy||!dirty)return; busy=true; dirty=false;
  const q=`theta=${theta}&phi=${phi}&radius=${radius}`+
    `&t=${$('time').value}&mode=${$('mode').value}&pose=${poseCSV()}`+
    `&sel=${sel}`;
  const img=new Image();
  img.onload=async()=>{
    ctx.drawImage(img,0,0,cv.width,cv.height);
    if($('skel').checked){
      const sk=await (await fetch('skeleton?'+q)).json();
      ctx.strokeStyle='#ff0';ctx.fillStyle='#f60';ctx.lineWidth=2;
      const sx=cv.width/info.width, sy=cv.height/info.height;
      for(const [a,b] of sk.bones){
        ctx.beginPath();
        ctx.moveTo(sk.xy[a][0]*sx,sk.xy[a][1]*sy);
        ctx.lineTo(sk.xy[b][0]*sx,sk.xy[b][1]*sy);ctx.stroke();}
      sk.xy.forEach((p,i)=>{if(!sk.alive[i])return;
        ctx.beginPath();ctx.arc(p[0]*sx,p[1]*sy,4,0,7);ctx.fill();});
    }
    busy=false;
  };
  img.onerror=()=>{busy=false;};
  img.src='render?'+q;
}
function loop(){draw();requestAnimationFrame(loop);}
let drag=null, moved=0, downXY=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY];moved=0;
  downXY=[e.offsetX,e.offsetY];};
window.onmouseup=async e=>{
  const wasClick=drag&&moved<4&&downXY;
  drag=null;
  if(!wasClick)return;
  // click (not drag): pick the dominant superpoint under the pixel
  const x=downXY[0]*info.width/cv.width, y=downXY[1]*info.height/cv.height;
  const q=`theta=${theta}&phi=${phi}&radius=${radius}`+
    `&t=${$('time').value}&pose=${poseCSV()}&x=${x}&y=${y}`;
  const p=await (await fetch('pick?'+q)).json();
  sel=p.superpoint;
  if(sel>=0){
    $('joint').value=sel;
    const d=pose[sel]||[0,0,0];
    $('rx').value=d[0];$('ry').value=d[1];$('rz').value=d[2];
    $('status').textContent=
      `picked superpoint/joint ${sel} (weight ${p.weight})`;
  }else{
    $('status').textContent='picked background';
  }
  dirty=true;};
window.onmousemove=e=>{
  if(!drag)return;
  moved+=Math.abs(e.clientX-drag[0])+Math.abs(e.clientY-drag[1]);
  theta+=(e.clientX-drag[0])*0.01; phi+=(e.clientY-drag[1])*0.01;
  phi=Math.max(-1.5,Math.min(1.5,phi));
  drag=[e.clientX,e.clientY]; dirty=true;};
cv.onwheel=e=>{e.preventDefault();radius*=Math.exp(e.deltaY*0.001);dirty=true;};
for(const id of ['time','mode','skel'])
  $(id).oninput=()=>{$('tv').textContent=(+$('time').value).toFixed(2);dirty=true;};
for(const id of ['rx','ry','rz'])
  $(id).oninput=()=>{
    const j=$('joint').value;
    pose[j]=[+$('rx').value,+$('ry').value,+$('rz').value];
    $('jx').textContent=$('rx').value;$('jy').textContent=$('ry').value;
    $('jz').textContent=$('rz').value; dirty=true;};
$('resetpose').onclick=()=>{pose={};
  for(const id of ['rx','ry','rz'])$(id).value=0; dirty=true;};
$('resetcam').onclick=()=>{theta=0;phi=0.3;radius=info.radius;dirty=true;};
init();
</script></body></html>"""


def superpoint_palette(m: int) -> np.ndarray:
    """A distinct colour per superpoint (a golden-ratio hue walk)."""
    hues = (np.arange(m) * 0.61803398875) % 1.0
    c = np.ones(m)
    x = 1.0 - np.abs((hues * 6) % 2 - 1)
    rgb = np.zeros((m, 3), np.float32)
    for i, h in enumerate(hues):
        k = int(h * 6) % 6
        r, g, b = [(c[i], x[i], 0), (x[i], c[i], 0), (0, c[i], x[i]),
                   (0, x[i], c[i]), (x[i], 0, c[i]), (c[i], 0, x[i])][k]
        rgb[i] = (r, g, b)
    return 0.2 + 0.8 * rgb


def dominant_superpoint(idx_px: np.ndarray, w_px: np.ndarray,
                        p2sp: np.ndarray, m: int):
    """The per-pixel top-k blend weights summed by superpoint: (the
    winning superpoint, its summed weight); (-1, 0.0) when no entry is
    valid (a background pixel). Entries < 0 or >= len(p2sp) are the top-k
    merge's padding."""
    valid = (idx_px >= 0) & (idx_px < len(p2sp))
    if not valid.any():
        return -1, 0.0
    sp_ids = p2sp[idx_px[valid]]
    acc = np.zeros(m, np.float64)
    np.add.at(acc, sp_ids, w_px[valid])
    sp = int(acc.argmax())
    return sp, float(acc[sp])


def parse_pose(s: str, m: int) -> np.ndarray:
    """[m, 3] float32 joint rotations from 'x,y,z;x,y,z;...' (missing or
    unparsable entries stay 0)."""
    out = np.zeros((m, 3), np.float32)
    if s:
        for i, part in enumerate(s.split(';')[:m]):
            try:
                vals = [float(v) for v in part.split(',')]
                out[i, :len(vals[:3])] = vals[:3]
            except ValueError:
                pass
    return out


class ViewerState:
    """The model, the render functions and the lock that serialises the
    device."""

    def __init__(self, cfg, scene, meta, skcfg, rcfg, model, stage: str):
        del cfg  # the JAX signature
        self.lock = threading.Lock()
        self.scene, self.meta = scene, meta
        self.skcfg, self.rcfg = skcfg, rcfg
        self.model = model
        self.stage = stage
        self.device = model.device
        self.w, self.h = scene.image_size
        self.radius0 = float(np.linalg.norm(scene.campos[0].cpu().numpy()))
        self.m = skcfg.num_superpoints
        self.palette = torch.from_numpy(superpoint_palette(self.m)).to(
            self.device)
        self.base_view = scene.view(0)
        self._render = {'rgb': self._render_rgb,
                        'superpoints': self._render_sp,
                        'opacity': self._render_rgb}

    def make_view(self, theta: float, phi: float, radius: float):
        """The orbit camera at (theta, phi, radius), looking at the origin
        (the base view's projection)."""
        eye = np.asarray([radius * np.cos(phi) * np.sin(theta),
                          radius * np.sin(phi),
                          -radius * np.cos(phi) * np.cos(theta)], np.float32)
        Tw2v = look_at(eye, np.zeros(3, np.float32),
                       np.asarray([0.0, -1.0, 0.0], np.float32),
                       coord='opencv', device=self.device)
        return self.base_view._replace(
            Tw2v=Tw2v, campos=torch.from_numpy(eye).to(self.device))

    def inputs(self, t, pose, stage: str = None):
        """The renderer's inputs at time ``t`` and pose ``pose`` [m, 3]
        (``sk_r_delta`` in the sk stages) and the deltas."""
        stage = stage or self.stage
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        pose = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        out_def = forward_deltas(
            self.skcfg, self.model, t, stage,
            sk_r_delta=pose if stage in ('sk', 'sk_fix') else None,
            training=False)
        g = gaussian_inputs(self.model.gauss_view(), self.skcfg.gauss,
                            d_xyz=out_def.d_xyz,
                            d_rotation=out_def.d_rotation,
                            d_scaling=out_def.d_scaling)
        return g, out_def

    def _render_rgb(self, view, t, pose, sel):
        del sel  # the highlight is the superpoint mode's
        g, _ = self.inputs(t, pose)
        out = render(g, view, self.rcfg,
                     active_sh_degree=self.model.active_sh_degree)
        img = composite_background(out['images'], out['opacity'],
                                   torch.ones(3, device=self.device))
        return img, out['opacity']

    def _render_sp(self, view, t, pose, sel):
        """Palette colours in place of SH, white for the picked superpoint
        (``sel`` >= 0), over a background of 0.1."""
        g, _ = self.inputs(t, pose)
        sp = self.model.p2sp.to(torch.int64) % self.m
        cols = torch.where((sp == sel)[:, None],
                           torch.ones(3, device=self.device),
                           self.palette[sp])
        out = render(g._replace(colors=cols, sh=None), view, self.rcfg)
        return composite_background(
            out['images'], out['opacity'],
            torch.full((3,), 0.1, device=self.device)), out['opacity']

    def render_png(self, theta, phi, radius, t, mode, pose,
                   sel: int = -1) -> bytes:
        with self.lock, torch.inference_mode():
            view = self.make_view(theta, phi, radius)
            img, opac = self._render[mode](view, t, pose, int(sel))
            if mode == 'opacity':
                arr = opac[..., None].expand(-1, -1, 3)
            else:
                arr = img
            arr = arr.cpu().numpy()
        return encode_png(to_uint8(arr))

    def pick_json(self, theta, phi, radius, t, pose, px: int,
                  py: int) -> bytes:
        """The dominant superpoint under pixel (px, py) by the per-pixel
        top-8 blend weights."""
        px = min(max(px, 0), self.w - 1)
        py = min(max(py, 0), self.h - 1)
        with self.lock, torch.inference_mode():
            view = self.make_view(theta, phi, radius)
            g, _ = self.inputs(t, pose)
            idx, wts = render_topk(g, view, self.rcfg, k=PICK_K)
            idx_px = idx[py, px].cpu().numpy()
            w_px = wts[py, px].cpu().numpy()
            p2sp = (self.model.p2sp.to(torch.int64) % self.m).cpu().numpy()
        sp, weight = dominant_superpoint(idx_px, w_px, p2sp, self.m)
        return json.dumps({'superpoint': sp, 'weight': round(weight, 4),
                           'x': px, 'y': py}).encode()

    def skeleton_2d(self, view, t, pose):
        """The joints at (t, pose) projected to pixels [m, 2] and their
        view-space depths [m] (always the ``sk`` stage's skeleton)."""
        _, out_def = self.inputs(t, pose, stage='sk')
        pos_w = se3_act(out_def.aux['skT'], self.model.params['joints'])
        hom = torch.cat([pos_w, torch.ones_like(pos_w[:, :1])], dim=-1)
        p_view = hom @ view.Tw2v.T
        p_clip = p_view @ view.Tv2c.T
        ndc = p_clip[:, :2] / torch.clamp(p_clip[:, 3:4], min=1e-6)
        x = ((ndc[:, 0] + 1) * self.w - 1) * 0.5
        y = ((ndc[:, 1] + 1) * self.h - 1) * 0.5
        return torch.stack([x, y], dim=-1), p_view[:, 2]

    def skeleton_json(self, theta, phi, radius, t, pose) -> bytes:
        with self.lock, torch.inference_mode():
            view = self.make_view(theta, phi, radius)
            xy, depth = self.skeleton_2d(view, t, pose)
            xy, depth = xy.cpu().numpy(), depth.cpu().numpy()
            parents = self.model.joint_parents[:, 0].cpu().numpy()
            alive = self.model.sp_alive.cpu().numpy()
            root = int(self.model.joint_root)
        # dead joints, and joints behind the camera, project to garbage:
        # neither their dots nor their bones are drawn
        ok = alive & np.isfinite(xy).all(-1) & (depth > 0) \
            & (np.abs(xy) < 4 * max(self.w, self.h)).all(-1)
        bones = [[int(i), int(parents[i])] for i in range(len(parents))
                 if ok[i] and ok[parents[i]] and i != root and parents[i] >= 0]
        xy = np.where(ok[:, None], xy, -1e4)
        return json.dumps({'xy': np.round(xy, 1).tolist(),
                           'alive': ok.astype(int).tolist(),
                           'bones': bones, 'root': root}).encode()

    def info_json(self) -> bytes:
        return json.dumps({
            'num_joints': self.m, 'num_superpoints': self.m,
            'width': self.w, 'height': self.h, 'stage': self.stage,
            'radius': self.radius0,
            'num_frames': int(self.meta.num_frames)}).encode()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            try:
                if u.path == '/':
                    self._send(200, 'text/html', PAGE.encode())
                elif u.path == '/info':
                    self._send(200, 'application/json', state.info_json())
                elif u.path in ('/render', '/skeleton', '/pick'):
                    try:
                        theta = float(q.get('theta', 0))
                        phi = float(q.get('phi', 0.3))
                        radius = float(q.get('radius', state.radius0))
                        t = min(max(float(q.get('t', 0)), 0.0), 1.0)
                    except ValueError as e:
                        self._send(400, 'text/plain',
                                   f'bad query parameter: {e}'.encode())
                        return
                    pose = parse_pose(q.get('pose', ''), state.m)
                    if u.path == '/render':
                        mode = q.get('mode', 'rgb')
                        if mode not in MODES:
                            self._send(400, 'text/plain',
                                       f'bad mode {mode!r}'.encode())
                            return
                        sel = int(q.get('sel', -1))
                        self._send(200, 'image/png', state.render_png(
                            theta, phi, radius, t, mode, pose, sel))
                    elif u.path == '/pick':
                        self._send(200, 'application/json', state.pick_json(
                            theta, phi, radius, t, pose,
                            int(float(q.get('x', 0))),
                            int(float(q.get('y', 0)))))
                    else:
                        self._send(200, 'application/json',
                                   state.skeleton_json(theta, phi, radius,
                                                       t, pose))
                else:
                    self._send(404, 'text/plain', b'not found')
            except BrokenPipeError:
                pass
            except Exception as e:  # the error goes to the client
                log.exception('request failed')
                self._send(500, 'text/plain', repr(e).encode())
    return Handler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('-c', '--config', required=True)
    ap.add_argument('--load', required=True)
    ap.add_argument('--port', type=int, default=8090)
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--stage', default='sk',
                    help='forward mode: sk/sp/init/static')
    ap.add_argument('--set', nargs='*', default=[], dest='overrides')
    ap.add_argument('--device', default='cuda')
    return ap.parse_args(argv)


def build_state(args) -> ViewerState:
    """The scene, the model configs and the checkpoint's model (at its own
    capacity) on ``args.device``."""
    device = resolve_device(args.device)
    cfg = make_config(args.config, args.overrides)
    scene, meta, _, _ = build.build_scene(cfg, device)
    skcfg, rcfg = build.build_model_cfg(cfg, meta, scene.image_size)
    cap = capacity_of(args.load)
    if cap != skcfg.gauss.capacity:
        skcfg = skcfg._replace(gauss=skcfg.gauss._replace(capacity=cap))
    model = model_from_flat(load(args.load), skcfg, rcfg, device)
    return ViewerState(cfg, scene, meta, skcfg, rcfg, model, args.stage)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    state = build_state(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    log.info('viewer at http://%s:%d/ (stage=%s, %s)', args.host,
             server.server_address[1], args.stage, state.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == '__main__':
    main()
