"""Visualization exports (port of gpis_tpu/viz/export.py): PLY meshes and
clouds with a variance colormap, and one self-contained HTML viewer (the
mesh, the atlas charts and the next-best path as JSON, drawn by a small
orbiting canvas renderer).  Host-side NumPy: the inputs are what the
session returns.
"""

from __future__ import annotations

import json

import numpy as np

from gpis_tpu_torch.data.io import save_ply

__all__ = ["variance_colormap", "export_isosurface_ply", "export_cloud_ply", "export_html"]


def variance_colormap(var):
    """Map variance to RGB in [0,1]: blue (certain) -> red (uncertain)."""
    v = np.asarray(var, np.float64)
    lo, hi = float(np.min(v)), float(np.max(v))
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    return np.stack([t, 0.2 * np.ones_like(t), 1.0 - t], axis=-1)


def export_isosurface_ply(path, verts, faces, variance=None, normals=None):
    """Triangle mesh with per-vertex variance colors; faces appended as an
    ASCII element (readable by meshlab/open3d)."""
    colors = variance_colormap(variance) if variance is not None else None
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        cols = None if colors is None else np.clip(colors * 255, 0, 255).astype(np.uint8)
        for i, v in enumerate(verts):
            row = list(v)
            if normals is not None:
                row += list(np.asarray(normals)[i])
            f.write(" ".join(f"{x:.6f}" for x in row))
            if cols is not None:
                f.write(" " + " ".join(str(int(c)) for c in cols[i]))
            f.write("\n")
        for face in faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def export_cloud_ply(path, points, variance=None, normals=None):
    colors = variance_colormap(variance) if variance is not None else None
    save_ply(path, points, normals=normals, colors=colors)


def export_html(path, verts, faces, variance=None, charts=None, best_path=None):
    """Self-contained HTML viewer: mesh + optional chart discs + path,
    rendered with a tiny orbiting software projector on a 2D canvas."""
    payload = {
        "verts": np.asarray(verts, np.float32).round(5).tolist(),
        "faces": np.asarray(faces, np.int32).tolist(),
        "colors": (variance_colormap(variance).round(3).tolist() if variance is not None else None),
        "charts": charts or [],
        "path": (np.asarray(best_path, np.float32).round(5).tolist() if best_path is not None else []),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gpis-tpu viewer</title>
<style>body{margin:0;background:#111;color:#ccc;font:13px sans-serif}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag to orbit &middot; wheel to zoom</div>
<canvas id="c"></canvas>
<script>
const D=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();}
let yaw=0.7,pitch=0.4,zoom=220;
function proj(p){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const x=p[0]*cy+p[2]*sy, z=-p[0]*sy+p[2]*cy;
  const y=p[1]*cp-z*sp, zz=p[1]*sp+z*cp;
  return [W/2+x*zoom, H/2-y*zoom, zz];
}
function draw(){
  ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
  const tris=[];
  for(let i=0;i<D.faces.length;i++){
    const f=D.faces[i];
    const a=proj(D.verts[f[0]]),b=proj(D.verts[f[1]]),c=proj(D.verts[f[2]]);
    tris.push([ (a[2]+b[2]+c[2])/3, a,b,c, f ]);
  }
  tris.sort((p,q)=>p[0]-q[0]);
  for(const [z,a,b,c,f] of tris){
    let col='#4488cc';
    if(D.colors){const m=D.colors[f[0]];col=`rgb(${m[0]*255|0},${m[1]*255|0},${m[2]*255|0})`;}
    ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.lineTo(c[0],c[1]);
    ctx.closePath();ctx.fillStyle=col;ctx.globalAlpha=0.85;ctx.fill();
  }
  ctx.globalAlpha=1;
  for(const ch of D.charts){
    ctx.strokeStyle='#66ff99';ctx.lineWidth=1.5;ctx.beginPath();
    for(let k=0;k<=16;k++){
      const t=k/16*2*Math.PI;
      const p=[0,1,2].map(d=>ch.center[d]+ch.radius*(Math.cos(t)*ch.u[d]+Math.sin(t)*ch.v[d]));
      const q=proj(p); k?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);
    }
    ctx.stroke();
  }
  if(D.path.length){ctx.strokeStyle='#ffdd00';ctx.lineWidth=3;ctx.beginPath();
    D.path.forEach((p,i)=>{const q=proj(p);i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});
    ctx.stroke();}
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*.01;pitch+=(e.clientY-drag[1])*.01;drag=[e.clientX,e.clientY];draw();}};
cv.onwheel=e=>{zoom*=e.deltaY<0?1.1:0.9;draw();e.preventDefault();};
window.onresize=rs;rs();
</script></body></html>
"""
