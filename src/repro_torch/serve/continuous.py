"""Slot-level continuous batching over a block-paged KV pool.

The port of `repro.serve.continuous` in its paged mode, the default for
decoder-only all-attention models:

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
The contiguous slot cache (``prefill_len``) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .batching import Request, RequestError
from .engine import GenerationEngine
from .metrics import ServeMetrics
from .paged import PageAllocator
from .prefix import PrefixCache
from .router import AdmissionRouter

__all__ = ["ContinuousBatcher"]


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: list          # generated so far (python ints)
    length: int           # valid cache columns (incl. generated)
    fed: int = 0          # prompt tokens streamed so far (starts at the
                          # prefix-cache hit length)
    promoted: int = 0     # leading block-table pages that are shared
    chain: bytes = b""    # chain digest after page ``promoted - 1``
    promo_dead: bool = False  # promotion stopped (digest registered first
                              # by a concurrent request)


class ContinuousBatcher:
    """Continuous batching over a fixed slot pool and a page pool.

    ``n_slots`` fixes the decode batch, ``page_size`` the page granularity,
    ``n_pages`` the pool (default: full capacity, ``1 + n_slots *
    ceil(max_len / page_size)``), ``prefill_chunk`` the tokens streamed per
    slot per step (default ``page_size``). Counters: ``decode_steps``,
    ``decode_tokens``, ``prefills`` (prompt completions), ``chunk_calls``,
    ``tokens_out``, ``model_calls``.
    """

    def __init__(self, engine: GenerationEngine, n_slots: int = 4,
                 pad_id: int = 0, rng: Optional[torch.Generator] = None,
                 page_size: int = 64,
                 prefill_chunk: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 router: Union[AdmissionRouter, str, None] = None,
                 tenant_weights: Optional[dict] = None,
                 tenant_cap: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
        self.engine = engine
        self.n = n_slots
        self.pad_id = pad_id
        self.rng = rng
        why = self.pageable_reason(engine)
        if why is not None:
            raise ValueError(f"paged serving unsupported: {why}")
        self.paged = True
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk or page_size)
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")
        self.max_pages = -(-engine.max_len // self.page_size)
        self.n_pages = (int(n_pages) if n_pages is not None
                        else 1 + n_slots * self.max_pages)
        self.allocator = PageAllocator(self.n_pages)
        self.block_table = np.zeros((n_slots, self.max_pages), np.int32)
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache is None or prefix_cache:
            self.prefix = PrefixCache(self.allocator, self.page_size)
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
        self.dead_slots: set[int] = set()
        self.cache = None  # page-pool cache, built at first admission
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
        """Chunk calls + decode steps — the occupancy denominator."""
        return self.decode_steps + self.chunk_calls

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
        if len(req.prompt) + req.n_new > self.engine.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens + n_new={req.n_new} "
                f"exceeds the block table's capacity (engine max_len="
                f"{self.engine.max_len})")
        if self._pages_needed(req) > self.n_pages - 1:
            raise ValueError(
                f"request needs {self._pages_needed(req)} pages but the pool "
                f"has {self.n_pages - 1} allocatable pages (n_pages="
                f"{self.n_pages} incl. the trash page)")
        self._rids.add(req.rid)
        err = self.queue.push(req)
        if err is not None:
            req.error = err
            self.done[req.rid] = req
            self.metrics.on_reject(req.rid)
        else:
            self.metrics.on_submit(req.rid, req.tenant)

    def _admit(self):
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
        logits, self.cache = eng._prefill_chunk(
            eng.params, self._device(toks), self.cache, self._device(offs),
            self._device(feeds), self._device(bt), self.page_size)
        self.chunk_calls += 1
        bad = eng.nonfinite_rows(logits[:, -1])
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
        before = set(self.done)
        self._admit()
        if self.queue and len(self.dead_slots) >= self.n:
            while self.queue:
                req = self.queue.popleft()
                req.error = RequestError(
                    rid=req.rid, stage="admit", step=0,
                    reason="all slots quarantined by decode-step faults")
                self.done[req.rid] = req
                self.metrics.on_error(req.rid)
        elif (self.queue and all(s is None for s in self.slots)
              and self._head_starved()):
            req = self.queue.popleft()
            req.error = RequestError(
                rid=req.rid, stage="admit", step=0,
                reason=f"request needs {self._pages_needed(req)} pages but "
                       f"only {self.allocator.n_free} remain allocatable "
                       f"({self.allocator.n_leaked} leaked by quarantined "
                       f"slots)")
            self.done[req.rid] = req
            self.metrics.on_error(req.rid)
        self._chunk_step()
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and s.fed == len(s.req.prompt)]
        if active:
            eng = self.engine
            # per-slot lengths INCLUDING this step's write; 0 = empty slot
            slot_lens = np.zeros(self.n, np.int32)
            bt = np.zeros_like(self.block_table)
            for i in active:
                slot_lens[i] = self.slots[i].length + 1
                bt[i] = self.block_table[i]
            logits, self.cache = eng._decode(
                eng.params, self._device(self.tok), self.cache,
                self._device(slot_lens), self._device(bt), self.page_size)
            self.decode_steps += 1
            bad = eng.nonfinite_rows(logits[:, -1])
            toks = eng._sample(logits[:, -1], self.rng).cpu().numpy()
            for i in active:
                st = self.slots[i]
                if bad[i]:
                    st.req.error = RequestError(
                        rid=st.req.rid, stage="decode", step=len(st.tokens),
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
        percentiles, per-tenant service + fairness, the page economy and the
        prefix-cache hit rates."""
        a = self.allocator
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
            "chunk_calls": self.chunk_calls,
            "pages_allocatable": self.n_pages - 1,
            "pages_in_use": a.pages_in_use, "pages_shared": a.n_shared,
            "pages_leaked": a.n_leaked, "pages_free": a.n_free,
            "pages_peak_in_use": a.peak_in_use,
        }
        if self.prefix is not None:
            s.update(self.prefix.stats())
        s.update(self.metrics.summary())
        return s
