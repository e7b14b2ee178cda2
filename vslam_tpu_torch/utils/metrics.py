"""Structured per-frame metrics + timing.

The reference's observability is two printfs (reference src/vslam.cpp:278,
src/PointMap.cpp:33). Here: a JSONL metrics stream with per-stage wall times
and the counters SURVEY.md §5 calls for (inliers, associations, map size,
track health, fps).

Beside the records the logger keeps the host's spans and syncs of the
record being built: ``span(name)`` stamps a stretch of host work with
``time.time_ns()`` (the clock of ``torch.profiler``'s events, so spans line
up with a device trace), and ``fetch`` is the driver's one way to copy
device data to the host, counting each call as one sync. ``begin`` starts
a record's spans and count; ``traced`` hands them over for the record.
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
        self.begin()

    def log(self, **kv):
        rec = dict(kv)
        rec.setdefault("t", time.time())
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def begin(self):
        """Start a new record's spans and sync count."""
        self.spans: List[list] = []
        self.syncs = 0

    def traced(self) -> Dict[str, Any]:
        """The spans ([name, start_ns, end_ns] in start order; they may
        nest) and the syncs since ``begin``, as a record's fields."""
        return {"spans": self.spans, "syncs": self.syncs}

    @contextmanager
    def span(self, name: str):
        """Record the enclosed host work as a span (``time.time_ns()``)."""
        s = [name, time.time_ns(), None]
        self.spans.append(s)
        try:
            yield
        finally:
            s[2] = time.time_ns()

    def fetch(self, *tensors):
        """Host numpy copies of ``tensors`` (the array itself for one
        tensor, else a tuple) in one host sync, which it counts; recorded
        as a ``fetch`` span. Several tensors of a card are copied
        asynchronously and waited for once."""
        with self.span("fetch"):
            if len(tensors) == 1:
                out = tensors[0].detach().cpu().numpy()
            else:
                host = [t.detach().to("cpu", non_blocking=True)
                        for t in tensors]
                dev = tensors[0].device
                if dev.type == "cuda":
                    import torch
                    torch.cuda.current_stream(dev).synchronize()
                out = tuple(h.numpy() for h in host)
        self.syncs += 1
        return out

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
