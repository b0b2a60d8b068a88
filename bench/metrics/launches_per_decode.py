"""Kernel launches the host issued inside the bench's decode spans, per
decode call (the profiler's runtime launch events)."""


def read(run):
    p = run["profile"]
    n = p["span_count"].get("decode", 0)
    return p["span_launches"].get("decode", 0) / n if n else None
