"""Kernel launches the host issued inside the bench's train-step spans,
per step (the profiler's runtime launch events)."""


def read(run):
    p = run["profile"]
    n = p["span_count"].get("train_step", 0)
    return p["span_launches"].get("train_step", 0) / n if n else None
