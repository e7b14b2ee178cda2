"""Structured per-frame metrics + timing.

The reference's observability is two printfs (reference src/vslam.cpp:278,
src/PointMap.cpp:33). Here: a JSONL metrics stream with per-stage wall times
and the counters SURVEY.md §5 calls for (inliers, associations, map size,
track health, fps).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Dict[str, Any]] = []
        self._fh = open(path, "a") if path else None

    def log(self, **kv):
        rec = dict(kv)
        rec.setdefault("t", time.time())
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        yield
        self.log(stage=name, wall_s=time.perf_counter() - t0)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def summary(self) -> Dict[str, Any]:
        frames = [r for r in self.records if r.get("kind") == "frame"]
        if not frames:
            return {}
        keys = ("num_matches", "num_inliers", "num_associated",
                "num_new_points", "wall_s")
        out: Dict[str, Any] = {"frames": len(frames)}
        for k in keys:
            vals = [r[k] for r in frames if k in r]
            if vals:
                out[f"mean_{k}"] = sum(vals) / len(vals)
        walls = [r["wall_s"] for r in frames if "wall_s" in r]
        if walls:
            out["fps"] = len(walls) / max(sum(walls), 1e-9)
        return out
