"""Decode tokens over decode slots offered, over the whole window (%):
how full the batcher keeps its decode calls."""


def read(run):
    c = run.get("counters") or {}
    if not c.get("decode_steps"):
        return None
    return 100.0 * c["decode_tokens"] / (c["decode_steps"] * c["slots"])
