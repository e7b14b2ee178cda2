"""Streaming map viewer: append-only JSONL + an HTML page that tails it.

The reference renders live on a second thread sharing mutable state under a
mutex (reference src/display.cpp:17-59, with the documented vector-realloc
race, SURVEY.md §3.4). The TPU rebuild's live mode is pull-based and
immutable instead: the pipeline appends *delta* records (new points since
the last update + the current trajectory tail) to ``stream.jsonl``, and
``live.html`` polls the file over HTTP (serve the output dir with
``python -m http.server``) using a byte offset so each poll transfers only
new lines. This replaces the round-1 ``--snapshot-every`` full-HTML rewrite
(VERDICT r01 "next" #10).

Map maintenance (eviction + compaction, mapping/point_map.compact) renumbers
ids and shrinks the cloud; when the stream detects that, it emits a
``reset`` record carrying the full current cloud, and the viewer rebuilds.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


class MapStream:
    """Appends snapshot deltas to <out_dir>/stream.jsonl; writes live.html
    once. Use from the tracking loop at any cadence."""

    def __init__(self, out_dir: str, max_reset_points: int = 60000):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "stream.jsonl")
        self.max_reset_points = max_reset_points
        self._written_pts = 0
        self._written_traj = 0
        open(self.path, "w").close()          # truncate: one stream per run
        write_live_html(os.path.join(out_dir, "live.html"))

    def update(self, snapshot: Dict[str, np.ndarray], frame: int) -> None:
        pts = np.asarray(snapshot["points"])
        colors = snapshot.get("colors")
        poses = snapshot.get("poses")
        traj = (np.asarray(poses)[:, :3, 3] if poses is not None and
                len(poses) else np.zeros((0, 3), np.float32))

        rec = {"frame": int(frame), "map_size": int(len(pts))}
        if len(pts) < self._written_pts:
            # compaction/eviction shrank or renumbered the cloud: resync
            sel = np.arange(len(pts))
            if len(pts) > self.max_reset_points:
                sel = np.random.RandomState(0).choice(
                    len(pts), self.max_reset_points, replace=False)
            rec["reset"] = True
            rec["points"] = np.round(pts[sel], 3).tolist()
            if colors is not None and len(colors):
                rec["colors"] = _rgb(np.asarray(colors)[sel])
            self._written_pts = len(pts)
            self._written_traj = 0
        else:
            new = pts[self._written_pts:]
            rec["points"] = np.round(new, 3).tolist()
            if colors is not None and len(colors):
                rec["colors"] = _rgb(np.asarray(colors)[self._written_pts:])
            self._written_pts = len(pts)

        rec["traj"] = np.round(traj[self._written_traj:], 3).tolist()
        self._written_traj = len(traj)

        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _rgb(colors01):
    return np.clip(np.asarray(colors01) * 255, 0, 255).astype(int).tolist()


_LIVE_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vslam_tpu live</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;font-size:12px}</style></head>
<body><canvas id="c"></canvas>
<div id="hud">live: <span id="st">connecting</span> &middot; drag: orbit
&middot; wheel: zoom &middot; shift-drag: pan</div>
<script>
let PTS=[], COLS=[], TRAJ=[], offset=0, frame=-1;
const cv=document.getElementById('c'), ctx=cv.getContext('2d');
const st=document.getElementById('st');
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
 for(let i=0;i<PTS.length;i++){
  const q=proj(PTS[i]); if(!q)continue;
  const c=COLS[i]||[200,200,200];
  ctx.fillStyle=`rgb(${c[0]},${c[1]},${c[2]})`;
  const r=Math.max(0.6,2.2-q[2]*0.01);
  ctx.fillRect(q[0],q[1],r,r);
 }
 ctx.strokeStyle='#f33';ctx.lineWidth=2;ctx.beginPath();
 let started=false;
 for(const p of TRAJ){const q=proj(p);if(!q){started=false;continue;}
  if(!started){ctx.moveTo(q[0],q[1]);started=true;}else ctx.lineTo(q[0],q[1]);}
 ctx.stroke();
}
async function poll(){
 try{
  const r=await fetch('stream.jsonl',{headers:{'Range':`bytes=${offset}-`}});
  if(r.status===200||r.status===206){
   const text=await r.text();
   // servers without Range support return the whole file (status 200)
   const fresh=(r.status===200)?text.slice(offset):text;
   offset=(r.status===200)?text.length:offset+text.length;
   let drew=false;
   for(const line of fresh.split('\\n')){
    if(!line.trim())continue;
    let rec; try{rec=JSON.parse(line);}catch(e){continue;}
    if(rec.reset){PTS=[];COLS=[];TRAJ=[];}
    if(rec.points){PTS.push(...rec.points);}
    if(rec.colors){COLS.push(...rec.colors);}
    if(rec.traj){TRAJ.push(...rec.traj);}
    frame=rec.frame; drew=true;
   }
   if(drew){st.textContent=`frame ${frame} · ${PTS.length} pts`;draw();}
  }
 }catch(e){st.textContent='waiting for stream.jsonl (serve this dir over http)';}
 setTimeout(poll, 1000);
}
resize(); poll();
</script></body></html>
"""


def write_live_html(path: str) -> str:
    with open(path, "w") as f:
        f.write(_LIVE_HTML)
    return path
