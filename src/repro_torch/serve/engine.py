"""Serving engine: the model's paged decode and chunk entries plus sampling.

The port of `repro.serve.engine` for the paged continuous batcher. The
reference jits ``decode_step`` and ``prefill_chunk`` with the page pool
donated; the port runs them eagerly and updates the pool in place. Solo
``generate`` (the contiguous-cache path) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ExecConfig, ModelConfig
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
        self.model = Model(self.cfg, self.exec_cfg, device=self.device)
        self.plan = self.model.plan  # resolved operator dispatch table
        if self.params is not None:
            self.params = params_to(self.params, self.device)

    def explain_plan(self) -> str:
        """The resolved slot -> backend table this engine serves with."""
        return self.plan.explain()

    @torch.no_grad()
    def _decode(self, params, token, cache, slot_lens, block_table,
                page_size):
        return self.model.decode_step(params, token, cache,
                                      slot_lens=slot_lens,
                                      block_table=block_table,
                                      page_size=page_size)

    @torch.no_grad()
    def _prefill_chunk(self, params, tokens, cache, chunk_offs, chunk_lens,
                       block_table, page_size):
        return self.model.prefill_chunk(params, tokens, cache, chunk_offs,
                                        chunk_lens, block_table, page_size)

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
