"""Window-BA events that solved, over all events of the window, in percent
(the program's ``kind: "ba"`` records; an event skipped by the starvation
or the exploration gate carries ``skipped``)."""


def read(run):
    ev = [r for r in run.records if r.get("kind") == "ba"]
    if not ev:
        return None
    return 100.0 * sum(1 for r in ev if "skipped" not in r) / len(ev)
