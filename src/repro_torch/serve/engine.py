"""Serving engine: prefill/decode entries over KV caches, plus generation.

The port of `repro.serve.engine`. `GenerationEngine.generate` serves one
batch end to end on a contiguous cache (prefill, then greedy or temperature
decoding): solo requests, or a left-padded bucket of `serve.batching` with
per-row ``pad_lens``; an encoder-decoder's ``enc_feats`` go to its
prefill. The paged continuous batcher drives ``_decode`` and
``_prefill_chunk`` on a block-paged pool. The reference jits these entries
with the cache donated; the port runs them eagerly and updates the caches
in place.

With ``ExecConfig.mesh`` naming more than one device, the engine builds
the mesh once for its device kind, so a CUDA mesh larger than the
process's cards raises here (a mesh built earlier onto an explicit device
list is reused), and places the parameter tree on it under `param_specs`
(the reference's ``device_put`` at load): Megatron stripes over
``model``, and with ``ModelConfig.fsdp`` the ``pod``/``data`` axes handed
to the ``heads``, ``mlp`` and ``vocab`` stripes too, so a tree too large
for one card loads in stripes (`repro_torch.dist.place_model_params`).
Resident int8 weights replicate. The model gathers each layer onto its
device as it runs it; attention shards through the plan's
``raceit_*_tp`` backends and the MoE FFNs through `models.moe`, each
reading the same ``ExecConfig.mesh``. Where every position is one card,
a placed leaf is the tensor it was made from, and its stripes views of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, trace
from ..configs.base import ExecConfig, ModelConfig
from ..dist.sharding import place_model_params
from ..models import Model
from ..models.model import params_to

__all__ = ["GenerationEngine"]


@dataclasses.dataclass
class GenerationEngine:
    cfg: ModelConfig
    params: dict
    exec_cfg: ExecConfig = ExecConfig()
    max_len: int = 512
    temperature: float = 0.0  # 0 => greedy
    device: Optional[object] = None  # None => cuda (raises without a card)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        spec = self.exec_cfg.mesh
        self.mesh = None
        if spec is not None and spec.n_devices > 1:
            self.mesh = spec.build(kind=self.device.type)
        self.model = Model(self.cfg, self.exec_cfg, device=self.device)
        self.plan = self.model.plan  # resolved operator dispatch table
        if self.params is not None:
            self.params = (params_to(self.params, self.device)
                           if self.mesh is None else
                           place_model_params(self.params, self.cfg,
                                              self.mesh))

    def explain_plan(self) -> str:
        """The resolved slot -> backend table this engine serves with."""
        return self.plan.explain()

    @torch.no_grad()
    def generate(self, prompts, n_new: int,
                 gen: Optional[torch.Generator] = None,
                 pad_lens: Optional[np.ndarray] = None,
                 enc_feats=None) -> np.ndarray:
        """prompts: (B, P) int32 -> (B, n_new) generated ids.

        ``pad_lens`` (B,) int32: per-row left-pad prefix lengths of a
        mixed-length bucket. Pad columns are masked out of every attention
        step and real tokens keep their solo positions. Sampling at
        ``temperature > 0`` draws from ``gen`` (a generator on the engine's
        device) in place of the reference's per-step key splits.
        ``enc_feats`` (B, encoder_len, d_model): an encoder-decoder's
        encoder input; without them its decoder attends to zero cross keys
        and values, as the reference's does.
        """
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=self.device)
        B, P = prompts.shape
        assert P + n_new <= self.max_len
        if pad_lens is not None:
            pad_lens = torch.as_tensor(np.asarray(pad_lens), dtype=torch.int32,
                                       device=self.device)
        cache = self.model.init_cache(B, self.max_len)
        logits, cache = self._prefill(self.params, prompts, cache,
                                      pad_lens=pad_lens, enc_feats=enc_feats)
        tok = self._sample(logits[:, -1], gen)
        out = [tok]
        pad_plen = (torch.tensor(P, dtype=torch.int32, device=self.device)
                    if pad_lens is not None else None)
        for _ in range(n_new - 1):
            logits, cache = self._decode(self.params, tok[:, None], cache,
                                         pad_lens=pad_lens,
                                         pad_prompt_len=pad_plen)
            tok = self._sample(logits[:, -1], gen)
            out.append(tok)
        return torch.stack(out, dim=1).cpu().numpy()

    @torch.no_grad()
    def _prefill(self, params, tokens, cache, pad_lens=None, enc_feats=None):
        with trace.span("engine.prefill"):
            return self.model.prefill(params, tokens, cache,
                                      enc_feats=enc_feats, pad_lens=pad_lens)

    @torch.no_grad()
    def _decode(self, params, token, cache, slot_lens=None, block_table=None,
                page_size=None, pad_lens=None, pad_prompt_len=None):
        with trace.span("engine.decode"):
            return self.model.decode_step(params, token, cache,
                                          slot_lens=slot_lens,
                                          block_table=block_table,
                                          page_size=page_size,
                                          pad_lens=pad_lens,
                                          pad_prompt_len=pad_prompt_len)

    @torch.no_grad()
    def _prefill_chunk(self, params, tokens, cache, chunk_offs, chunk_lens,
                       block_table, page_size):
        with trace.span("engine.prefill_chunk"):
            return self.model.prefill_chunk(params, tokens, cache, chunk_offs,
                                            chunk_lens, block_table,
                                            page_size)

    @staticmethod
    def nonfinite_rows(logits: torch.Tensor) -> np.ndarray:
        """(B,) bool host mask: rows whose logits contain NaN/Inf."""
        finite = torch.isfinite(logits).reshape(logits.shape[0], -1).all(-1)
        return (~finite).cpu().numpy()

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
