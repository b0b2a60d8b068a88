"""The work of each hand-written kernel: bytes moved and int8 operations.

One reckoning, read by two callers: `chip_smoke.py` divides it by the
card's rates for each kernel's bound (``bound_ms``, PERF.md's bound
column), and the op counter of `repro_torch.launch.op_analysis` adds it to
a traced step for the dry-run's roofline. Bytes are the function's own:
each input read once, each output written once, never a kernel's scratch;
operations are int8 multiplies and adds (an ADC plane of the MVM, a table
step of the LUT and softmax, counted as one operation per element).

A call's work is split over its launches: the two-pass attention kernels
read q, K, the mask and the lengths and do q.K in pass A, read V, write
the output and do PROB.V in pass B; a one-tile call is one launch with
both. ``live`` is the key rows the call reads over all its groups (the sum
of the clamped ``kv_len``) and ``pairs`` the (query, key) pairs that are
not masked: counted from the data where the caller has it (the chip
check), else from the shapes alone (`static_live`, `static_pairs`), which
is what a launch on ``meta`` tensors and the op counter take, so a traced
step counts the same work on the card as on ``meta``.

`counted` is the hook a wrapper puts around its launches: a no-op unless
an op counter is active, in which case the ops dispatched inside are not
counted and the call's `Launch` records are added instead.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["Launch", "bound_ms", "total", "paged_attention", "paged_prolog",
           "contiguous_attention", "lut", "mvm", "softmax", "static_live",
           "static_pairs", "counted"]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the ``launches`` key of its wrapper, the pass
    ("A", "B", or "" for a one-launch call) and its share of the call's
    bytes and int8 operations."""
    kernel: str
    part: str
    nbytes: float
    ops: float

    @property
    def name(self) -> str:
        return f"{self.kernel}.{self.part}" if self.part else self.kernel


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card: bytes over the HBM rate against int8
    operations over the int8 peak (datasheet figures, `launch.mesh`), the
    larger of the two, and which one it was."""
    from ..launch.mesh import HBM_BW, PEAK_INT8_OPS
    t_bytes, t_ops = nbytes / HBM_BW, ops / PEAK_INT8_OPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def total(launches) -> tuple[float, float]:
    """(bytes, operations) of a call, all its launches."""
    return (sum(x.nbytes for x in launches), sum(x.ops for x in launches))


def static_live(G: int, Sk: int, kv_len=None) -> int:
    """Key rows a call can read, from its shapes: G x Sk, or G x a Python
    ``kv_len`` (clamped to Sk); a tensor length counts Sk."""
    if kv_len is not None and not hasattr(kv_len, "shape"):
        return G * min(int(kv_len), Sk)
    return G * Sk


def static_pairs(G: int, Sq: int, Sk: int, live: int, causal: bool = False,
                 q_offset=0) -> int:
    """(query, key) pairs from the shapes: every query against every live
    key, or, in-kernel causal with a Python offset, row i against keys
    ``<= i + q_offset`` of the live ones."""
    per_group = live // G if G else 0
    if causal and not hasattr(q_offset, "shape"):
        return G * sum(min(per_group, max(0, i + int(q_offset) + 1))
                       for i in range(Sq))
    return Sq * live


def paged_attention(G: int, Sq: int, D: int, live: int, bt_numel: int,
                    kvlen_numel: int, mask_numel: int = 0) -> list:
    """The paged kernel's two launches (int8 q, K and V, an int32 block
    table, lengths and output, an int8 mask)."""
    a = Launch("acam_attention_paged", "A",
               G * Sq * D + live * D + 4 * bt_numel + 4 * kvlen_numel
               + mask_numel, 2 * Sq * live * D)
    b = Launch("acam_attention_paged", "B", live * D + 4 * G * Sq * D,
               2 * Sq * live * D)
    return [a, b]


def paged_prolog(n_q: int, n_slots: int, max_pages: int, n_pages: int,
                 page_size: int, row: int, rep: int, itemsize: int) -> list:
    """The paged entries' operand prolog (``csrc/acam_prolog.cu``): the max
    launch reads float32 q, the live rows of the K and V pools (``row``
    elements a row, ``itemsize`` bytes each), the block table and the
    lengths; the quantise launch writes q's codes and the K/V codes of the
    pages the table names, each KV head ``rep`` times. From the shapes:
    every entry live on its own page, as many as the pool holds besides the
    trash page, which the table names too."""
    named = min(n_slots * max_pages, n_pages - 1)
    a = Launch("acam_prolog", "A",
               4 * n_q + 2 * named * page_size * row * itemsize
               + 4 * n_slots * max_pages + 4 * n_slots, 0)
    b = Launch("acam_prolog", "B",
               n_q + 2 * (named + 1) * page_size * row * rep, 0)
    return [a, b]


def contiguous_attention(G: int, Sq: int, D: int, live: int, pairs: int,
                         mask_numel: int = 0, single: bool = False) -> list:
    """The contiguous kernel's two launches, or the one-tile kernel's one:
    q . K over the unmasked pairs, PROB . V over every live key (a masked
    key keeps its weight in the row at the LOGIT minimum)."""
    read_a = G * Sq * D + live * D + 4 * G + mask_numel
    read_b = live * D + 4 * G * Sq * D
    ops_a, ops_b = 2 * D * pairs, 2 * D * Sq * live
    if single:
        return [Launch("acam_attention_single", "", read_a + read_b,
                       ops_a + ops_b)]
    return [Launch("acam_attention", "A", read_a, ops_a),
            Launch("acam_attention", "B", read_b, ops_b)]


def lut(n: int, x_itemsize: int, lut_numel: int) -> list:
    """``lut[x + bias]`` over n codes: codes in, int32 out, the table."""
    return [Launch("acam_lut", "", n * x_itemsize + 4 * n + 4 * lut_numel,
                   n)]


def mvm(M: int, K: int, N: int, planes: int = 1) -> list:
    """int8 (M, K) x (K, N) -> int32, ``planes`` bit-slice products (1 for
    the exact ADC)."""
    return [Launch("acam_mvm", "", M * K + K * N + 4 * M * N,
                   2 * M * N * K * planes)]


def softmax(n: int, x_itemsize: int) -> list:
    """The Fig.-8 softmax over n codes: codes in, int32 out, the four
    256-entry tables; four table steps an element."""
    return [Launch("acam_softmax", "", n * x_itemsize + 4 * n + 4 * 4 * 256,
                   4 * n)]


# the active op counters (`launch.op_analysis`), innermost last
COUNTERS: list = []


def counted(launches_fn):
    """Context around one kernel call: when an op counter is active, it
    records ``launches_fn()`` (a list of `Launch`) and skips the ops the
    call dispatches; otherwise nothing (``launches_fn`` is not called)."""
    if not COUNTERS:
        return contextlib.nullcontext()
    return COUNTERS[-1].kernel_call(launches_fn())
