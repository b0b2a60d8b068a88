"""Slot-level continuous batching: retire-and-admit without draining.

The port of `repro.serve.continuous`. A fixed pool of slots over one KV
cache, in one of two forms.

**Contiguous** (``paged=False``, an explicit ``prefill_len``, or a model
with no paged cache form): the slot cache is `Model.init_slot_cache`
without pages, (n_slots, max_len) buffers with one write index per slot.

    admit    a queued request is prefilled solo at the pool's pinned
             ``prefill_len`` width, left-padded (pad columns masked, real
             tokens at their solo positions), and its cache row is written
             into a free slot (`scatter_row`);
    decode   one (n_slots, 1) `Model.decode_step` call decodes every slot at
             its own fill level (``slot_lens``; 0 = an empty slot).

``prefill_len`` locks to the longest prompt queued at the first admission
when it is not given.

**Paged** (the default for decoder-only all-attention models):

    admit    reserve every page the request can ever need (prompt +
             n_new - 1 tokens, `PageAllocator`) — all-or-nothing, so a
             running request never stalls on allocation; with the prefix
             cache on, hit pages are mapped into the block-table row first
             and streaming starts at the first miss;
    chunk    one (n_slots, prefill_chunk) `Model.prefill_chunk` call per step
             streams every mid-prompt slot's next chunk into its pages;
    decode   one (n_slots, 1) `Model.decode_step` call decodes every slot
             whose prompt is in, the block table riding along.

Per-call block tables fence non-participants: a decode call zeroes the rows
of slots still mid-prompt and a chunk call zeroes the rows of decoding
slots, so their pad-token writes land on the trash page 0. Quarantined
slots (non-finite logits) leak their private pages, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .. import trace
from .batching import Request, RequestError
from .engine import GenerationEngine
from .metrics import ServeMetrics
from .paged import PageAllocator
from .prefix import PrefixCache
from .router import AdmissionRouter

__all__ = ["ContinuousBatcher", "scatter_row"]


def scatter_row(pool: list, row: list, slot: int) -> None:
    """Write a batch-1 contiguous cache (`Model.init_cache(1, ...)`) into
    row ``slot`` of a contiguous slot cache, in place: every leaf of every
    layer's cache (an attention layer's k/v row and its write index, a Mamba
    layer's SSM state and conv rows). The reference updates the donated
    pool functionally; the port writes the one it holds."""
    for p, r in zip(pool, row):
        for kind, leaves in p.items():
            for name, leaf in leaves.items():
                src = r[kind][name]
                leaf[slot] = (src[0] if src.ndim == leaf.ndim else src).to(
                    leaf.dtype)


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list          # generated so far (python ints)
    length: int           # valid cache columns (pad + real, incl. generated)
    pad: int = 0          # left-pad columns in this slot's cache (contiguous)
    fed: int = 0          # prompt tokens streamed so far (starts at the
                          # prefix-cache hit length)
    promoted: int = 0     # leading block-table pages that are shared
    chain: bytes = b""    # chain digest after page ``promoted - 1``
    promo_dead: bool = False  # promotion stopped (digest registered first
                              # by a concurrent request)


class ContinuousBatcher:
    """Continuous batching over a fixed slot pool.

    ``n_slots`` fixes the decode batch. Paged (see `pageable_reason`):
    ``page_size`` sets the page granularity, ``n_pages`` the pool (default:
    full capacity, ``1 + n_slots * ceil(max_len / page_size)``),
    ``prefill_chunk`` the tokens streamed per slot per step (default
    ``page_size``). Contiguous (``paged=False`` or a ``prefill_len``):
    admission prefills at the pinned ``prefill_len`` width. Counters:
    ``decode_steps``, ``decode_tokens``, ``prefills`` (paged: prompt
    completions), ``chunk_calls``, ``tokens_out``, ``model_calls``.
    """

    def __init__(self, engine: GenerationEngine, n_slots: int = 4,
                 prefill_len: Optional[int] = None, pad_id: int = 0,
                 rng: Optional[torch.Generator] = None,
                 paged: Optional[bool] = None, page_size: int = 64,
                 prefill_chunk: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 router: Union[AdmissionRouter, str, None] = None,
                 tenant_weights: Optional[dict] = None,
                 tenant_cap: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
        self.engine = engine
        # mesh-sharded serving: the batcher never touches the mesh itself
        # (the TP attention backends shard the pool inside the model call;
        # block tables and slot lengths stay replicated host state), it
        # only reports the shape and the resolved decode backend in
        # summary(), so a degraded mesh (non-dividing KV heads) shows there
        _mesh = getattr(engine.exec_cfg, "mesh", None)
        self.mesh_spec = (_mesh if _mesh is not None
                          and getattr(_mesh, "n_devices", 1) > 1 else None)
        self.n = n_slots
        self.prefill_len = prefill_len
        self.pad_id = pad_id
        self.rng = rng
        why = self.pageable_reason(engine)
        if paged is None:
            # paged when the model qualifies; a prefill_len pins contiguous
            paged = prefill_len is None and why is None
        elif paged:
            if why is not None:
                raise ValueError(f"paged serving unsupported: {why}")
            if prefill_len is not None:
                raise ValueError(
                    "prefill_len pins the contiguous admission path; paged "
                    "mode streams prompts in chunks — pass prefill_chunk "
                    "to size the chunk instead")
        self.paged = paged
        self.prefix: Optional[PrefixCache] = None
        if paged:
            self.page_size = int(page_size)
            self.prefill_chunk = int(prefill_chunk or page_size)
            if self.page_size < 1 or self.prefill_chunk < 1:
                raise ValueError("page_size and prefill_chunk must be >= 1")
            self.max_pages = -(-engine.max_len // self.page_size)
            self.n_pages = (int(n_pages) if n_pages is not None
                            else 1 + n_slots * self.max_pages)
            self.allocator = PageAllocator(self.n_pages)
            self.block_table = np.zeros((n_slots, self.max_pages), np.int32)
            if prefix_cache is None or prefix_cache:
                self.prefix = PrefixCache(self.allocator, self.page_size)
        elif prefix_cache:
            raise ValueError(
                "the prefix cache shares immutable pages of the block-paged "
                "pool; contiguous slot caches have nothing to share — drop "
                "prefix_cache or serve paged")
        if isinstance(router, AdmissionRouter):
            if tenant_weights is not None or tenant_cap is not None:
                raise ValueError(
                    "pass tenant_weights/tenant_cap to the AdmissionRouter "
                    "you are constructing, not alongside an instance")
            self.queue = router
        else:
            self.queue = AdmissionRouter(policy=router or "fifo",
                                         weights=tenant_weights,
                                         max_queue_per_tenant=tenant_cap)
        self.metrics = ServeMetrics()
        self._rids: set[int] = set()
        self.done: dict[int, Request] = {}
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        # slots quarantined by decode-step (or, paged, chunk-call) faults;
        # a contiguous admission-prefill fault quarantines nothing (the solo
        # prefill is not tied to a slot row)
        self.dead_slots: set[int] = set()
        self.cache = None  # slot-pool cache, built at first admission
        self.tok = np.full((n_slots, 1), pad_id, np.int32)
        self.decode_steps = 0
        self.decode_tokens = 0
        self.prefills = 0
        self.chunk_calls = 0
        self.tokens_out = 0

    # ------------------------------------------------------------ lifecycle
    @staticmethod
    def pageable_reason(engine: GenerationEngine) -> Optional[str]:
        """None when the model can serve block-paged, else the reason."""
        cfg = engine.cfg
        if cfg.is_encoder_decoder:
            return "encoder-decoder stacks serve bucketed, not slot-pooled"
        mixers = {cfg.layer_spec(i)[0] for i in range(cfg.n_layers)}
        if mixers != {"attn"}:
            return (f"mixers {sorted(mixers - {'attn'})} have no paged "
                    f"cache form (local ring buffers / SSM state)")
        return None

    @property
    def model_calls(self) -> int:
        """Prefill executions + decode steps — the occupancy denominator
        (paged: chunk calls; contiguous: admission prefills)."""
        if self.paged:
            return self.decode_steps + self.chunk_calls
        return self.decode_steps + self.prefills

    def _pages_needed(self, req: Request) -> int:
        # the prompt plus the n_new - 1 decode-step writes
        return -(-(len(req.prompt) + req.n_new - 1) // self.page_size)

    def _head_starved(self) -> bool:
        """True when the policy head can never be admitted (every slot empty)."""
        head = self.queue[0]
        need = self._pages_needed(head)
        headroom = self.allocator.n_free
        if self.prefix is not None:
            hits, _, _ = self.prefix.match(head.prompt)
            need -= len(hits)
            headroom += self.prefix.n_evictable(
                pinned=frozenset(page for _, page in hits))
        return need > headroom

    def submit(self, req: Request):
        if req.rid in self._rids:
            raise ValueError(
                f"duplicate rid {req.rid}: a request with this rid was "
                f"already submitted to this batcher (done, running, or "
                f"queued) — rids key the result map and page ownership")
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt — the first "
                             f"token is sampled from the prompt's last "
                             f"position, so there is nothing to prefill")
        if self.paged:
            if len(req.prompt) + req.n_new > self.engine.max_len:
                raise ValueError(
                    f"prompt of {len(req.prompt)} tokens + n_new={req.n_new} "
                    f"exceeds the block table's capacity (engine max_len="
                    f"{self.engine.max_len})")
            if self._pages_needed(req) > self.n_pages - 1:
                raise ValueError(
                    f"request needs {self._pages_needed(req)} pages but the "
                    f"pool has {self.n_pages - 1} allocatable pages (n_pages="
                    f"{self.n_pages} incl. the trash page)")
        else:
            if (self.prefill_len is not None
                    and len(req.prompt) > self.prefill_len):
                raise ValueError(
                    f"prompt of {len(req.prompt)} tokens exceeds the pool's "
                    f"pinned prefill_len={self.prefill_len}")
            # the slot holds the (padded) prompt plus every generated token
            width = (self.prefill_len if self.prefill_len is not None
                     else len(req.prompt))
            if width + req.n_new > self.engine.max_len:
                raise ValueError(
                    f"prompt width {width} + n_new={req.n_new} exceeds the "
                    f"engine's max_len={self.engine.max_len}")
        self._rids.add(req.rid)
        err = self.queue.push(req)
        if err is not None:
            req.error = err
            self.done[req.rid] = req
            self.metrics.on_reject(req.rid)
        else:
            self.metrics.on_submit(req.rid, req.tenant)
            trace.queued(req.rid)

    def _lock_prefill_len(self):
        """Pin the contiguous admission width to the longest queued prompt,
        failing at once (nothing admitted, queue intact) when the queued
        requests cannot all fit slots of that shared width."""
        if self.prefill_len is not None:
            return
        width = max(len(r.prompt) for r in self.queue)
        worst = max(r.n_new for r in self.queue)
        if width + worst > self.engine.max_len:
            raise ValueError(
                f"queued requests are jointly infeasible: pool width would "
                f"lock to {width} (longest prompt) but a request with "
                f"n_new={worst} then exceeds max_len={self.engine.max_len};"
                f" pass an explicit prefill_len or split the traffic")
        self.prefill_len = width

    def _admit(self):
        """Fill free slots from the queue: contiguous, a solo prefill and a
        row scatter; paged, pages and a block-table row."""
        if self.paged:
            self._admit_paged()
            return
        eng = self.engine
        for slot in range(self.n):
            if (slot in self.dead_slots or self.slots[slot] is not None
                    or not self.queue):
                continue
            self._lock_prefill_len()
            head = self.queue[0]  # validated before it is popped
            P = len(head.prompt)
            if P > self.prefill_len:
                raise ValueError(
                    f"prompt of {P} tokens exceeds the pool's pinned "
                    f"prefill_len={self.prefill_len}")
            if self.prefill_len + head.n_new > eng.max_len:
                raise ValueError(
                    f"pinned prefill_len={self.prefill_len} + "
                    f"n_new={head.n_new} exceeds the engine's "
                    f"max_len={eng.max_len}")
            req = self.queue.popleft()
            pad = self.prefill_len - P
            prompt = np.full((1, self.prefill_len), self.pad_id, np.int32)
            prompt[0, pad:] = req.prompt
            row_cache = eng.model.init_cache(1, eng.max_len)
            trace.started(req.rid)
            logits, row_cache = eng._prefill(
                eng.params, self._device(prompt), row_cache,
                pad_lens=self._device(np.array([pad], np.int32)))
            self.prefills += 1
            with trace.span("serve.readback", site="admit"):
                bad = bool(eng.nonfinite_rows(logits[:, -1])[0])
            if bad:
                # retire the request before its row reaches the pool; the
                # slot stays free
                req.error = RequestError(
                    rid=req.rid, stage="prefill", step=0,
                    reason="non-finite logits from the admission prefill")
                self.done[req.rid] = req
                self.metrics.on_error(req.rid)
                continue
            if self.cache is None:
                self.cache = eng.model.init_slot_cache(self.n, eng.max_len)
            scatter_row(self.cache, row_cache, slot)
            with trace.span("serve.readback", site="admit"):
                tok0 = int(eng._sample(logits[:, -1], self.rng).cpu()[0])
            # the prompt is in the cache; the first token is written by the
            # next decode step
            self.tokens_out += 1
            self.metrics.on_first_token(req.rid, req.tenant)
            self.tok[slot, 0] = tok0
            self.slots[slot] = _Slot(req=req, tokens=[tok0],
                                     length=self.prefill_len, pad=pad)
            self._retire_if_done(slot)

    def _admit_paged(self):
        """Reserve pages + block-table rows for queued requests (the head
        blocks when it does not fit: admission never overrides the router)."""
        eng = self.engine
        for slot in range(self.n):
            if (slot in self.dead_slots or self.slots[slot] is not None
                    or not self.queue):
                continue
            head = self.queue[0]
            hits, digest, hit_tokens = [], b"", 0
            if self.prefix is not None:
                hits, digest, hit_tokens = self.prefix.match(head.prompt)
            hit_pages = [page for _, page in hits]
            need = self._pages_needed(head) - len(hit_pages)
            if need > self.allocator.n_free and self.prefix is not None:
                self.prefix.evict(need - self.allocator.n_free,
                                  pinned=frozenset(hit_pages))
            pages = self.allocator.alloc(slot, need)
            if pages is None:
                break  # backpressure: head stays queued, policy intact
            req = self.queue.popleft()
            for page in hit_pages:
                self.allocator.acquire(slot, page)
            if self.prefix is not None:
                self.prefix.commit(hits, len(head.prompt) // self.page_size)
            if self.cache is None:
                self.cache = eng.model.init_slot_cache(
                    self.n, eng.max_len, page_size=self.page_size,
                    n_pages=self.n_pages)
            self.block_table[slot, :] = 0
            self.block_table[slot, : len(hit_pages)] = hit_pages
            self.block_table[slot, len(hit_pages):
                             len(hit_pages) + len(pages)] = pages
            self.slots[slot] = _Slot(req=req, tokens=[], length=0,
                                     fed=hit_tokens, promoted=len(hit_pages),
                                     chain=digest)

    def _quarantine(self, slot: int):
        """Retire a faulted slot row for the rest of the run (pages leak)."""
        self.slots[slot] = None
        self.tok[slot, 0] = self.pad_id
        self.dead_slots.add(slot)
        if self.paged:
            self.allocator.leak_slot(slot)
            self.block_table[slot, :] = 0

    def _retire_if_done(self, slot: int) -> bool:
        st = self.slots[slot]
        if st is None or len(st.tokens) < st.req.n_new:
            return st is None
        st.req.result = np.asarray(st.tokens[: st.req.n_new], np.int32)
        self.done[st.req.rid] = st.req
        self.slots[slot] = None
        self.tok[slot, 0] = self.pad_id
        if self.paged:
            self.allocator.free_slot(slot)
            self.block_table[slot, :] = 0
        return True

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.engine.device)

    def _chunk_step(self):
        """One (n_slots, prefill_chunk) chunk call over every mid-prompt slot;
        a slot whose prompt completes samples its first token here."""
        feeding = [i for i, s in enumerate(self.slots)
                   if s is not None and s.fed < len(s.req.prompt)]
        if not feeding:
            return
        eng = self.engine
        C = self.prefill_chunk
        toks = np.full((self.n, C), self.pad_id, np.int32)
        offs = np.zeros(self.n, np.int32)
        feeds = np.zeros(self.n, np.int32)
        bt = np.zeros_like(self.block_table)
        for i in feeding:
            st = self.slots[i]
            feed = min(C, len(st.req.prompt) - st.fed)
            toks[i, :feed] = st.req.prompt[st.fed: st.fed + feed]
            offs[i] = st.fed
            feeds[i] = feed
            bt[i] = self.block_table[i]
            if trace.on:  # closes the request's queue wait on its first chunk
                trace.started(st.req.rid)
        logits, self.cache = eng._prefill_chunk(
            eng.params, self._device(toks), self.cache, self._device(offs),
            self._device(feeds), self._device(bt), self.page_size)
        self.chunk_calls += 1
        with trace.span("serve.readback", site="chunk"):
            bad = eng.nonfinite_rows(logits[:, -1])
        with trace.span("serve.readback", site="chunk"):
            sampled = eng._sample(logits[:, -1], self.rng).cpu().numpy()
        for i in feeding:
            st = self.slots[i]
            if bad[i]:
                st.req.error = RequestError(
                    rid=st.req.rid, stage="prefill", step=st.fed,
                    reason="non-finite logits from a prefill chunk")
                self.done[st.req.rid] = st.req
                self.metrics.on_error(st.req.rid)
                self._quarantine(i)
                continue
            st.fed += int(feeds[i])
            self._promote_streamed(i)
            if st.fed == len(st.req.prompt):
                self.prefills += 1
                tok0 = int(sampled[i])
                st.tokens.append(tok0)
                st.length = len(st.req.prompt)
                self.tokens_out += 1
                self.metrics.on_first_token(st.req.rid, st.req.tenant)
                self.tok[i, 0] = tok0
                self._retire_if_done(i)

    def _promote_streamed(self, slot: int):
        """Register this slot's fully-streamed prompt pages as shared."""
        st = self.slots[slot]
        if self.prefix is None or st.promo_dead:
            return
        ps = self.page_size
        prompt = st.req.prompt
        limit = min(st.fed, len(prompt)) // ps  # pages fully streamed
        while st.promoted < limit:
            lo = st.promoted * ps
            page = int(self.block_table[slot, st.promoted])
            ok, nxt = self.prefix.promote(slot, page, st.chain,
                                          prompt[lo: lo + ps])
            if not ok:
                st.promo_dead = True
                break
            st.chain = nxt
            st.promoted += 1

    # ---------------------------------------------------------------- steps
    def step(self) -> list[int]:
        """Admit, chunk mid-prompt slots, then decode the pool once.

        Returns the rids retired by this step.
        """
        self.metrics.tick()
        with trace.span("serve.step", step=self.metrics.step):
            before = set(self.done)
            with trace.span("serve.admit"):
                self._admit()
            if self.queue and len(self.dead_slots) >= self.n:
                while self.queue:
                    req = self.queue.popleft()
                    req.error = RequestError(
                        rid=req.rid, stage="admit", step=0,
                        reason="all slots quarantined by decode-step faults")
                    self.done[req.rid] = req
                    self.metrics.on_error(req.rid)
            elif (self.paged and self.queue
                  and all(s is None for s in self.slots)
                  and self._head_starved()):
                req = self.queue.popleft()
                req.error = RequestError(
                    rid=req.rid, stage="admit", step=0,
                    reason=f"request needs {self._pages_needed(req)} pages "
                           f"but only {self.allocator.n_free} remain "
                           f"allocatable ({self.allocator.n_leaked} leaked "
                           f"by quarantined slots)")
                self.done[req.rid] = req
                self.metrics.on_error(req.rid)
            if self.paged:
                with trace.span("serve.chunk"):
                    self._chunk_step()
            # mid-prefill paged slots sit the decode out as empty rows
            active = [i for i, s in enumerate(self.slots)
                      if s is not None
                      and (not self.paged or s.fed == len(s.req.prompt))]
            if active:
                with trace.span("serve.decode"):
                    eng = self.engine
                    # per-slot lengths INCLUDING this step's write; 0 =
                    # an empty slot
                    slot_lens = np.zeros(self.n, np.int32)
                    for i in active:
                        slot_lens[i] = self.slots[i].length + 1
                    if self.paged:
                        bt = np.zeros_like(self.block_table)
                        for i in active:
                            bt[i] = self.block_table[i]
                        logits, self.cache = eng._decode(
                            eng.params, self._device(self.tok), self.cache,
                            self._device(slot_lens), self._device(bt),
                            self.page_size)
                    else:
                        pad_lens = np.zeros(self.n, np.int32)
                        for i in active:
                            pad_lens[i] = self.slots[i].pad
                        logits, self.cache = eng._decode(
                            eng.params, self._device(self.tok), self.cache,
                            self._device(slot_lens),
                            pad_lens=self._device(pad_lens),
                            pad_prompt_len=self.prefill_len)
                    self.decode_steps += 1
                    with trace.span("serve.readback", site="decode"):
                        bad = eng.nonfinite_rows(logits[:, -1])
                    with trace.span("serve.readback", site="decode"):
                        toks = eng._sample(logits[:, -1],
                                           self.rng).cpu().numpy()
                    for i in active:
                        st = self.slots[i]
                        if bad[i]:
                            st.req.error = RequestError(
                                rid=st.req.rid, stage="decode",
                                step=len(st.tokens),
                                reason="non-finite logits at the decode step")
                            self.done[st.req.rid] = st.req
                            self.metrics.on_error(st.req.rid)
                            self._quarantine(i)
                            continue
                        st.length += 1
                        st.tokens.append(int(toks[i]))
                        self.tokens_out += 1
                        self.decode_tokens += 1
                        self.metrics.on_token(st.req.rid, st.req.tenant)
                        self.tok[i, 0] = int(toks[i])
                        self._retire_if_done(i)
        return sorted(set(self.done) - before)

    def run_all(self) -> dict[int, Request]:
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return self.done

    def summary(self) -> dict:
        """End-of-run service report: occupancy counters, step-clock latency
        percentiles, per-tenant service + fairness and, paged, the page
        economy and the prefix-cache hit rates."""
        s = {
            "requests_done": len(self.done),
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "tokens_out": self.tokens_out,
            "model_calls": self.model_calls,
            "router_policy": self.queue.policy,
            "router_rejected": self.queue.rejected,
            "queue_depths": self.queue.depths(),
            "fairness_jain": self.metrics.fairness(self.queue.weights),
        }
        if self.mesh_spec is not None:
            s["mesh"] = self.mesh_spec.describe()
            s["decode_backend"] = self.engine.plan.backend("attention_decode")
        if self.paged:
            a = self.allocator
            s.update(chunk_calls=self.chunk_calls,
                     pages_allocatable=self.n_pages - 1,
                     pages_in_use=a.pages_in_use, pages_shared=a.n_shared,
                     pages_leaked=a.n_leaked, pages_free=a.n_free,
                     pages_peak_in_use=a.peak_in_use)
            if self.prefix is not None:
                s.update(self.prefix.stats())
        s.update(self.metrics.summary())
        return s
