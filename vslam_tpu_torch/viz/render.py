"""Visualization: point cloud + camera frusta, headless-friendly.

TPU-native rebuild of the reference's Display (reference src/display.cpp:
Pangolin window, immediate-mode GL points + wireframe frusta on a render
thread sharing state through a mutex). Here rendering consumes *immutable
snapshots* (pipeline/slam.py ``snapshot``) — the data-race class documented
in SURVEY.md §3.4 cannot occur — and outputs:

  * PNG renders via matplotlib (orthographic top/side views + 3D),
  * a self-contained interactive HTML viewer (embedded JSON + canvas JS,
    zero external dependencies, works over any file transfer),
  * PLY point-cloud export for standard tools.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


def frustum_segments(pose: np.ndarray, scale: float = 0.5, aspect: float = 0.75):
    """Line segments of a wireframe camera frustum for pose T_wc
    (the functional form of draw_box, reference src/display.cpp:118-152)."""
    w = scale
    h = scale * aspect
    z = scale * 0.8
    pts_c = np.array(
        [[0, 0, 0], [-w, -h, z], [w, -h, z], [w, h, z], [-w, h, z]], np.float32
    )
    pts_w = pts_c @ pose[:3, :3].T + pose[:3, 3]
    idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts_w[i], pts_w[j]) for i, j in idx]


def render_png(snapshot: Dict[str, np.ndarray], path: str,
               max_points: int = 20000, title: str = "vslam_tpu map"):
    """Three-panel PNG: top-down (x-z), side (z-y), and 3D view."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = snapshot["points"]
    colors = snapshot.get("colors")
    poses = snapshot.get("keyframe_poses", snapshot.get("poses"))
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None

    fig = plt.figure(figsize=(15, 5))
    fig.suptitle(title)

    ax = fig.add_subplot(1, 3, 1)
    ax.scatter(pts[:, 0], pts[:, 2], s=1, c=colors if colors is not None else "k")
    if poses is not None and len(poses):
        traj = poses[:, :3, 3]
        ax.plot(traj[:, 0], traj[:, 2], "r-", lw=1.5)
    ax.set_xlabel("x [m]"); ax.set_ylabel("z [m]"); ax.set_title("top-down")
    ax.set_aspect("equal")

    ax = fig.add_subplot(1, 3, 2)
    ax.scatter(pts[:, 2], -pts[:, 1], s=1, c=colors if colors is not None else "k")
    if poses is not None and len(poses):
        ax.plot(traj[:, 2], -traj[:, 1], "r-", lw=1.5)
    ax.set_xlabel("z [m]"); ax.set_ylabel("-y [m]"); ax.set_title("side")
    ax.set_aspect("equal")

    ax3 = fig.add_subplot(1, 3, 3, projection="3d")
    ax3.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=1,
                c=colors if colors is not None else "k")
    if poses is not None and len(poses):
        ax3.plot(traj[:, 0], traj[:, 2], -traj[:, 1], "r-", lw=1.5)
        for T in poses[:: max(len(poses) // 24, 1)]:
            for a, b in frustum_segments(T):
                ax3.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                         "b-", lw=0.5)
    ax3.set_title("3D")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def save_ply(snapshot: Dict[str, np.ndarray], path: str):
    """ASCII PLY export of the map point cloud."""
    pts = snapshot["points"]
    colors = snapshot.get("colors")
    if colors is None:
        colors = np.full_like(pts, 0.7)
    rgb = np.clip(colors * 255, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vslam_tpu viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;font-size:12px}</style></head>
<body><canvas id="c"></canvas><div id="hud">drag: orbit &middot; wheel: zoom
&middot; shift-drag: pan</div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=-0.6, pitch=-0.4, dist=40, cx=0, cy=0, cz=30, panx=0, pany=0;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize',resize);
let drag=false,px=0,py=0,shift=false;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;shift=e.shiftKey;};
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-px,dy=e.clientY-py;px=e.clientX;py=e.clientY;
 if(shift){panx+=dx*dist/500;pany+=dy*dist/500;}else{yaw+=dx*0.008;pitch+=dy*0.008;}
 draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);draw();e.preventDefault();};
function proj(p){
 let x=p[0]-cx-panx, y=p[1]-cy+pany, z=p[2]-cz;
 let c=Math.cos(yaw),s=Math.sin(yaw);
 let x1=c*x+s*z, z1=-s*x+c*z;
 c=Math.cos(pitch);s=Math.sin(pitch);
 let y2=c*y-s*z1, z2=s*y+c*z1;
 z2+=dist;
 if(z2<0.2)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2, cv.height/2+f*y2/z2, z2];
}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 const pts=DATA.points, cols=DATA.colors;
 for(let i=0;i<pts.length;i++){
  const q=proj(pts[i]); if(!q)continue;
  const c=cols?cols[i]:[200,200,200];
  ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
  const r=Math.max(0.6,2.2-q[2]*0.01);
  ctx.fillRect(q[0],q[1],r,r);
 }
 ctx.strokeStyle='#f33';ctx.lineWidth=2;ctx.beginPath();
 let started=false;
 for(const p of DATA.trajectory){const q=proj(p);if(!q){started=false;continue;}
  if(!started){ctx.moveTo(q[0],q[1]);started=true;}else ctx.lineTo(q[0],q[1]);}
 ctx.stroke();
 ctx.strokeStyle='#39f';ctx.lineWidth=1;
 for(const seg of DATA.frusta){ctx.beginPath();
  const a=proj(seg[0]),b=proj(seg[1]);if(!a||!b)continue;
  ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
}
resize();
</script></body></html>
"""


def save_html(snapshot: Dict[str, np.ndarray], path: str,
              max_points: int = 30000):
    """Standalone interactive HTML viewer (no external deps)."""
    pts = snapshot["points"]
    colors = snapshot.get("colors")
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None
    poses = snapshot.get("keyframe_poses", snapshot.get("poses"))
    frusta = []
    if poses is not None and len(poses):
        for T in poses[:: max(len(poses) // 48, 1)]:
            for a, b in frustum_segments(np.asarray(T)):
                frusta.append([a.tolist(), b.tolist()])
    data = {
        "points": np.round(pts, 3).tolist(),
        "colors": (np.clip(colors * 255, 0, 255).astype(int).tolist()
                   if colors is not None else None),
        "trajectory": (np.round(poses[:, :3, 3], 3).tolist()
                       if poses is not None and len(poses) else []),
        "frusta": frusta,
    }
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", json.dumps(data)))
    return path
