"""Mean host milliseconds of an engine prefill call, synchronised, in the
traced slice: the paged chunk call, or the contiguous pool's solo
admission prefill."""


def read(run):
    ms = [m for name, m in run["spans"]
          if name in ("prefill_chunk", "prefill")]
    return sum(ms) / len(ms) if ms else None
