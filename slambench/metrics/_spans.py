"""Shared by the readers of the program's own spans: a record's spans of
one name (``MetricsLogger.span``: [name, start_ns, end_ns], on the
profiler's clock)."""


def spans_named(rec: dict, name: str):
    """[(start_ns, end_ns)] of ``rec``'s spans called ``name``."""
    return [(s, e) for n, s, e in rec.get("spans", ()) if n == name]
