"""Mean host milliseconds of an engine decode call, synchronised, in the
traced slice."""


def read(run):
    ms = [m for name, m in run["spans"] if name == "decode"]
    return sum(ms) / len(ms) if ms else None
