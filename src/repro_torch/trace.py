"""The port's tracer: spans and counters inside the program, on the
profiler's clock.

Off (the default), a span site reads the module flag ``on`` and gets the
shared no-op context `OFF`: no ``record_function``, no clock read, no
allocation, no kernel launch. `enable` switches it on; then
``span(name, ...)`` records

* a ``torch.profiler.record_function("rt." + name)`` range, on the
  profiler's timeline beside the device events, so a device-idle gap can
  be put down to the program span open on the host;
* an entry of the in-memory log: the name, its start and end
  (``time.perf_counter_ns``), the index of its parent entry (-1 at the
  top) and its ids: ``step`` and ``layer`` (given, or the parent's) and
  ``site``.

A request's queue wait (``req.queued``, `queued` to `started`, with its
``rid``) outlasts a step, so it lives in the log alone. `enable` emits two empty
``rt.anchor`` ranges and keeps the last one's midpoint on
``perf_counter_ns`` (``anchor_ns``): a profiler running at that moment
maps every log entry onto its clock, that range's midpoint there being
the same instant. A
span's stamps enclose its range (taken just before it opens and just
after it closes).

Counters: `add` sums a host int, or a device tensor in place (no sync),
under a name and a key; `snapshot` reads the device ones once. An
operator who runs any ``torch.profiler`` session with the tracer enabled
gets the ``rt.`` ranges in their trace.

Spans, by layer: ``serve.step`` (``step``) with ``serve.admit``,
``serve.chunk``, ``serve.decode`` and ``serve.readback`` (``site``
admit, chunk or decode) in `serve.continuous`; ``engine.decode``,
``engine.prefill_chunk``, ``engine.prefill`` in `serve.engine`;
``model.layer`` (``layer``) in `models.blocks`; ``plan.<slot>`` in
`exec.plan`; ``moe.route``, ``moe.experts``, ``moe.combine`` and the
counters ``moe.kept`` (kept (token, choice) pairs per expert, a device
int64 tensor) and ``moe.rows`` (the dispatch rows E x C), both keyed by
layer, in `models.moe`; the counters ``attn.prolog_fused`` and
``attn.prolog_plain`` (paged attention calls whose operand prolog ran as
the kernels of ``csrc/acam_prolog.cu``, or as their plain version; host
ints keyed by layer) in `kernels.ops`; ``train.step`` (``step``) with
``train.forward``, ``train.backward``, ``train.optimizer`` in
`train.trainer`.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["on", "OFF", "span", "queued", "started", "current", "add",
           "enable", "disable", "tracing", "snapshot"]

PREFIX = "rt."

on = False
anchor_ns = None
_log: list = []      # entries (dicts), in the order their spans opened
_stack: list = []    # indices of the open spans' entries
_waiting: dict = {}  # rid -> queued stamp (ns)
_counters: dict = {}  # name -> {key: int or device tensor}


OFF = contextlib.nullcontext()  # every span site's while the tracer is off


class _Span:
    __slots__ = ("entry", "range", "idx")

    def __init__(self, entry: dict):
        self.entry = entry

    def __enter__(self):
        e = self.entry
        parent = _stack[-1] if _stack else -1
        e["parent"] = parent
        if parent >= 0:
            up = _log[parent]
            for k in ("step", "layer"):
                if k not in e and k in up:
                    e[k] = up[k]
        self.idx = len(_log)
        _stack.append(self.idx)
        _log.append(e)
        self.range = torch.profiler.record_function(PREFIX + e["name"])
        e["start_ns"] = time.perf_counter_ns()
        self.range.__enter__()
        return None

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.entry["end_ns"] = time.perf_counter_ns()
        if _stack and _stack[-1] == self.idx:  # else: enable() cleared it
            _stack.pop()
        return False


def span(name: str, step=None, layer=None, site=None):
    """A context around one piece of the program's work; `OFF` while the
    tracer is off."""
    if not on:
        return OFF
    e = {"name": name}
    for k, v in (("step", step), ("layer", layer), ("site", site)):
        if v is not None:
            e[k] = v
    return _Span(e)


def queued(rid) -> None:
    """Request ``rid`` entered the queue."""
    if on:
        _waiting[rid] = time.perf_counter_ns()


def started(rid) -> None:
    """Request ``rid``'s first prefill work starts: its ``req.queued`` entry
    closes (nothing where it was queued while the tracer was off, or has
    started already)."""
    if on:
        t0 = _waiting.pop(rid, None)
        if t0 is not None:
            _log.append({"name": "req.queued", "rid": rid, "parent": -1,
                         "start_ns": t0, "end_ns": time.perf_counter_ns()})


def current(key: str):
    """The id ``key`` of the innermost open span (its own or inherited),
    else None."""
    return _log[_stack[-1]].get(key) if _stack else None


def add(name: str, value, key=None) -> None:
    """Add ``value`` to counter ``name`` under ``key``: a host int, or a
    device tensor summed in place where it lives (no sync)."""
    if not on:
        return
    slot = _counters.setdefault(name, {})
    old = slot.get(key)
    if old is None:
        slot[key] = value.clone() if isinstance(value, torch.Tensor) else value
    elif isinstance(old, torch.Tensor):
        old.add_(value)
    else:
        slot[key] = old + value


def enable() -> None:
    """Clear the log and the counters, switch the tracer on and emit the
    ``rt.anchor`` range."""
    global on, anchor_ns
    _log.clear()
    _stack.clear()
    _waiting.clear()
    _counters.clear()
    on = True
    for _ in range(2):  # a profiler session's first range opens slowly
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(PREFIX + "anchor"):
            pass
        anchor_ns = (t0 + time.perf_counter_ns()) // 2


def disable() -> None:
    global on
    on = False


@contextlib.contextmanager
def tracing():
    """The tracer on inside the block."""
    enable()
    try:
        yield
    finally:
        disable()


def snapshot() -> dict:
    """The log (an entry's ``parent`` is an index into it; a span still
    open has no ``end_ns``), the anchor and the counters, device ones read
    to the host here (once)."""
    counters = {name: {key: (v.tolist() if isinstance(v, torch.Tensor)
                             else v) for key, v in slot.items()}
                for name, slot in _counters.items()}
    return {"anchor_ns": anchor_ns,
            "spans": [dict(e) for e in _log],
            "counters": counters}
