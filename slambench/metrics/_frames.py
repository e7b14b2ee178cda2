"""Shared by the readers: a frame record's kind, the traced stretch's
ordinary frames, the ordinary frames outside it, and the live map a
frame searched."""


def kind_of(rec: dict) -> str:
    """A frame record's kind: maintenance, ba, keyframe or ordinary."""
    return ("maintenance" if rec.get("ran_maintenance") else
            "ba" if rec.get("ran_ba") else
            "keyframe" if rec.get("keyframe") else "ordinary")


def ordinary_traced(run):
    """[(trace frame, record)] of the traced stretch's ordinary frames."""
    if run.trace is None:
        return []
    out = []
    for f in run.trace.frames:
        rec = run.frame_record(f.index)
        if rec is not None and "success" in rec and \
                kind_of(rec) == "ordinary":
            out.append((f, rec))
    return out


def ordinary_replays(run):
    """[(record, replay s, latency s)] of the ordinary frames of a traced
    run outside its traced stretch: the step graph's replay on the device
    (CUDA events inside the graph) beside the frame's record and its
    host-clock latency."""
    out = []
    for i, replay in sorted(run.replay_s.items()):
        rec = run.frame_record(i)
        if rec is not None and "success" in rec and \
                kind_of(rec) == "ordinary":
            out.append((rec, replay, run.latencies[i - run.first]))
    return out


def live_map(run, index: int):
    """The insert cursor that frame ``index`` started from: what the frame
    before records as ``map_size``, or, where that frame's maintenance
    compacted the map, the size it left. None where the window holds no
    record of the frame before."""
    for r in run.records:
        if r.get("kind") == "map_maintenance" and r.get("frame") == index - 1:
            return r["size_after"]
    before = run.frame_record(index - 1)
    return before.get("map_size") if before is not None else None
