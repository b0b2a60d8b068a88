"""Attention's least time over the device time of the kernels launched
inside the bench's attention spans (%): the int8 operations of the
unmasked (query, key) pairs at the int8 peak against q, the live keys and
values and the output at the HBM rate, a layer at a time, from the
calls' shapes (`bench/yardstick/cost.py`)."""
from bench.yardstick import cost


def read(run):
    dev = run["profile"]["span_device_s"].get("attention", 0.0)
    need = sum(cost.attn_least_s(w, run["peaks"])
               for w in run.get("calls", []))
    if dev <= 0 or need <= 0:
        return None
    return 100.0 * need / dev
