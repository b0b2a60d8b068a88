"""Host milliseconds of a batcher step outside its model calls, in the
traced slice (the bench's spans, on a synchronised clock)."""

CALLS = ("decode", "prefill_chunk", "prefill")


def read(run):
    steps = [ms for name, ms in run["spans"] if name == "step"]
    if not steps:
        return None
    inner = sum(ms for name, ms in run["spans"] if name in CALLS)
    return (sum(steps) - inner) / len(steps)
