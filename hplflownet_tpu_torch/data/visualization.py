"""Headless visualization export for evaluation dumps.

The port's own copy of ``hplflownet_tpu/data/visualization.py`` (numpy
only; importing that module would load jax), writing the same bytes.  The
reference renders with Mayavi interactively; this exports the same scene —
pc1 (blue), ground-truth warp pc1+sf (red), prediction pc1+flow (green),
optionally pc2 (magenta) — two ways:

* standard PLY point clouds any viewer (MeshLab, CloudCompare, Open3D) can
  open, plus error-colored clouds;
* a self-contained interactive HTML viewer per scene (rotate / zoom / layer
  toggles / gt-to-pred error segments) — a single file with the clouds
  embedded, no network or install needed on the other end.

Usage:
    python -m hplflownet_tpu_torch.data.visualization VISU_DIR [--out-dir DIR]
(VISU_DIR = the ``visu_*`` directory that ``train.driver`` writes when it
evaluates with ``dump_visu: true``.)
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import os.path as osp

import numpy as np

__all__ = ["write_ply", "export_scene", "export_html", "main"]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Write an (N, 3) float cloud (+ optional (N, 3) uint8 colors) as PLY."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    with open(path, "wb") as fd:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header.append("end_header")
        fd.write(("\n".join(header) + "\n").encode())
        if has_color:
            colors = np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
            fd.write(rec.tobytes())
        else:
            fd.write(points.tobytes())


def _solid(n, rgb):
    return np.tile(np.asarray(rgb, np.uint8), (n, 1))


def export_scene(out_dir: str, idx: int, pc1, sf, flow, pc2=None):
    """Export one sample's clouds + an EPE-colored error cloud."""
    os.makedirs(out_dir, exist_ok=True)
    pc1 = np.asarray(pc1).reshape(-1, 3)
    sf = np.asarray(sf).reshape(-1, 3)
    flow = np.asarray(flow).reshape(-1, 3)

    write_ply(osp.join(out_dir, f"{idx:04d}_pc1.ply"), pc1,
              _solid(len(pc1), (64, 96, 255)))
    write_ply(osp.join(out_dir, f"{idx:04d}_gt.ply"), pc1 + sf,
              _solid(len(pc1), (255, 64, 64)))
    write_ply(osp.join(out_dir, f"{idx:04d}_pred.ply"), pc1 + flow,
              _solid(len(pc1), (64, 200, 64)))
    if pc2 is not None:
        pc2 = np.asarray(pc2).reshape(-1, 3)
        write_ply(osp.join(out_dir, f"{idx:04d}_pc2.ply"), pc2,
                  _solid(len(pc2), (200, 64, 200)))

    # error heat: green (0) -> red (>=0.3 m EPE)
    epe = np.linalg.norm(flow - sf, axis=-1)
    t = np.clip(epe / 0.3, 0, 1)
    colors = np.stack([255 * t, 255 * (1 - t), np.zeros_like(t)],
                      axis=-1).astype(np.uint8)
    write_ply(osp.join(out_dir, f"{idx:04d}_error.ply"), pc1 + flow, colors)

    # interactive single-file viewer of the same scene
    export_html(osp.join(out_dir, f"{idx:04d}_scene.html"), idx,
                pc1, sf, flow, pc2)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>scene __IDX__</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:rgba(0,0,0,.55);padding:8px
 12px;border-radius:6px;user-select:none}
label{margin-right:10px;cursor:pointer}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud"><b>HPLFlowNet scene __IDX__</b> &mdash; drag to rotate,
wheel to zoom, shift-drag to pan<br>__TOGGLES__
<span id="st"></span></div>
<script>
"use strict";
const F = s => new Float32Array(
  Uint8Array.from(atob(s), c => c.charCodeAt(0)).buffer);
const LAYERS = __LAYERS__;   // [name, color, base64 xyz, pointsize]
const clouds = LAYERS.map(l => ({name: l[0], col: l[1], p: F(l[2]),
                                 ps: l[3], on: l[0] !== 'pc2'}));
const segs = __SEGS__;       // base64 xyz pairs (gt->pred), or ""
const segP = segs ? F(segs) : null;
let segOn = false;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
// centroid + extent from the first cloud
const p0 = clouds[0].p; let cx=0, cy=0, cz=0;
for (let i=0;i<p0.length;i+=3){cx+=p0[i];cy+=p0[i+1];cz+=p0[i+2];}
const n0 = p0.length/3; cx/=n0; cy/=n0; cz/=n0;
let ext=0; for (let i=0;i<p0.length;i+=3){ext=Math.max(ext,
  Math.abs(p0[i]-cx),Math.abs(p0[i+1]-cy),Math.abs(p0[i+2]-cz));}
let th=0.5, ph=-0.4, zoom=0.9, panx=0, pany=0;
function draw(){
  const w = cv.width = innerWidth, h = cv.height = innerHeight;
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,w,h);
  const s = zoom*Math.min(w,h)/(2.2*ext);
  const ct=Math.cos(th), st=Math.sin(th), cp=Math.cos(ph), sp=Math.sin(ph);
  const prj = (x,y,z) => {
    x-=cx; y-=cy; z-=cz;
    const x1 =  ct*x + st*z, z1 = -st*x + ct*z;
    const y1 =  cp*y - sp*z1;
    return [w/2 + panx + s*x1, h/2 + pany - s*y1];
  };
  for (const c of clouds){
    if (!c.on) continue;
    ctx.fillStyle = c.col;
    const p = c.p, ps = c.ps;
    for (let i=0;i<p.length;i+=3){
      const q = prj(p[i],p[i+1],p[i+2]);
      ctx.fillRect(q[0],q[1],ps,ps);
    }
  }
  if (segOn && segP){
    ctx.strokeStyle = 'rgba(255,220,60,0.8)'; ctx.beginPath();
    for (let i=0;i<segP.length;i+=6){
      const a = prj(segP[i],segP[i+1],segP[i+2]);
      const b = prj(segP[i+3],segP[i+4],segP[i+5]);
      ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
    }
    ctx.stroke();
  }
  document.getElementById('st').textContent =
    ` | ${clouds.filter(c=>c.on).map(c=>c.name).join(' ')}`;
}
let drag=null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => { if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]) { panx+=dx; pany+=dy; } else { th+=dx*0.008; ph+=dy*0.008; }
  drag=[e.clientX,e.clientY,drag[2]]; draw(); };
onwheel = e => { zoom *= Math.exp(-e.deltaY*0.001); draw(); };
onresize = draw;
function toggle(name, box){
  if (name === 'segs') segOn = box.checked;
  else clouds.find(c => c.name === name).on = box.checked;
  draw();
}
draw();
</script></body></html>
"""


def _b64(points: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(points, dtype=np.float32).tobytes()).decode()


def export_html(out_path: str, idx: int, pc1, sf, flow, pc2=None,
                max_segments: int = 1024):
    """One self-contained interactive HTML file for a scene.

    Layers mirror the reference's Mayavi scene (visualization.py:68-99):
    pc1 blue, gt warp red, prediction green, optional pc2 magenta (off by
    default like the reference's commented-out pc2), plus yellow gt-to-pred
    segments for the ``max_segments`` worst-EPE points (the reference draws
    connecting lines for every point; capping keeps the file responsive)."""
    pc1 = np.asarray(pc1, np.float32).reshape(-1, 3)
    sf = np.asarray(sf, np.float32).reshape(-1, 3)
    flow = np.asarray(flow, np.float32).reshape(-1, 3)
    gt, pred = pc1 + sf, pc1 + flow
    layers = [("pc1", "#4060ff", _b64(pc1), 2),
              ("gt", "#ff4040", _b64(gt), 2),
              ("pred", "#40c840", _b64(pred), 2)]
    if pc2 is not None:
        layers.append(("pc2", "#c840c8",
                       _b64(np.asarray(pc2, np.float32).reshape(-1, 3)), 2))

    epe = np.linalg.norm(flow - sf, axis=-1)
    worst = np.argsort(-epe)[:max_segments]
    segs = np.concatenate([gt[worst], pred[worst]], axis=1)  # (k, 6)

    toggles = "".join(
        f'<label><input type="checkbox" {"checked" if name != "pc2" else ""} '
        f'onchange="toggle(\'{name}\', this)">{name}</label>'
        for name, *_ in layers)
    toggles += ('<label><input type="checkbox" '
                'onchange="toggle(\'segs\', this)">gt&rarr;pred segs</label>')
    html = (_HTML_TEMPLATE
            .replace("__IDX__", str(idx))
            .replace("__TOGGLES__", toggles)
            .replace("__LAYERS__", json.dumps(
                [[n, c, b, ps] for n, c, b, ps in layers]))
            .replace("__SEGS__", json.dumps(_b64(segs))))
    with open(out_path, "w") as fd:
        fd.write(html)


def main(argv=None) -> int:
    """Export every scene of a ``visu_*`` directory; -> the scene count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("visu_dir")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    out_dir = args.out_dir or osp.join(args.visu_dir, "ply")

    idx = 0
    count = 0
    while True:
        p = osp.join(args.visu_dir, f"pc1_{idx}.npy")
        if not osp.exists(p):
            break
        pc1 = np.load(p)
        sf = np.load(osp.join(args.visu_dir, f"sf_{idx}.npy"))
        flow = np.load(osp.join(args.visu_dir, f"output_{idx}.npy"))
        pc2_path = osp.join(args.visu_dir, f"pc2_{idx}.npy")
        pc2 = np.load(pc2_path) if osp.exists(pc2_path) else None
        for b in range(pc1.shape[0]):
            export_scene(out_dir, count, pc1[b], sf[b], flow[b],
                         None if pc2 is None else pc2[b])
            count += 1
        idx += 1
    print(f"exported {count} scenes to {out_dir}")
    return count


if __name__ == "__main__":
    main()
