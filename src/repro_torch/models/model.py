"""Top-level models: decoder LMs over a contiguous or block-paged KV cache,
encoder-only stacks (bert) and encoder-decoders (whisper).

The port of the inference half of `repro.models.model`:

    model = Model(cfg, exec_cfg, device="cuda")
    params = model.init(torch.Generator(device).manual_seed(0))
    logits = model.forward(params, {"tokens": ..., "enc_feats": ...})
    loss = model.loss_fn(params, {"tokens": ..., "loss_mask": ...})
    cache = model.init_cache(batch, max_len)            # solo / buckets
    logits, cache = model.prefill(params, prompts, cache, pad_lens=None)
    logits, cache = model.decode_step(params, token, cache)
    cache = model.init_slot_cache(n_slots, max_len)     # contiguous slots
    logits, cache = model.decode_step(params, token, cache, slot_lens=...,
                                      pad_lens=..., pad_prompt_len=...)
    cache = model.init_slot_cache(n_slots, max_len, page_size=64, n_pages=N)
    logits, cache = model.prefill_chunk(params, tokens, cache, offs, lens,
                                        block_table, page_size)
    logits, cache = model.decode_step(params, token, cache, slot_lens=...,
                                      block_table=..., page_size=...)

``params`` is ``{"embed": {...}, "final_norm": {...}, "blocks": [layer
dict, ...]}``, or for an encoder-decoder ``{"embed", "final_norm",
"encoder": [...], "enc_norm", "decoder": [...]}`` (decoder layers carry
``norm_x`` and ``cross``); `quantize_model_params` turns weight matrices
into resident `QuantizedWeight` codes bit-identical to the reference's.
An encoder-decoder's cache is ``{"dec": [layer caches], "enc_kv": [(k, v)
per decoder layer]}``: `prefill` with ``enc_feats`` fills ``enc_kv`` from
the encoder; without them the decoder attends to the zeros `init_cache`
made, as in the reference.

``params`` may be placed on a mesh (`repro_torch.dist.place_params`): each
entry point gathers the embeddings and norms onto the model's device, and
the layer stacks are gathered a layer at a time (`blocks.apply_stack`).

``Model(cfg, exec_cfg, device, mesh_ctx=MeshContext(mesh))`` is the
reference's model under `use_policy` (its training): `forward`,
`loss_fn` and `loss_sums` split the batch over the mesh's data replicas,
and each replica's ``model`` positions compute their own heads, FFN
columns, vocab rows, sequence shard and SSM heads or chunks
(`repro_torch.dist.tp`; `blocks.apply_stack_tp`). The cached entry
points (serving) run as without it, as the reference's engine never
enters the policy.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..configs.base import ExecConfig, ModelConfig
from ..dist.sharding import MeshContext, Placed, gather_tree, is_placed
from ..dist.tp import all_gather, all_max, all_reduce, replica_groups
from ..exec.plan import ExecPlan, as_plan
from . import blocks, layers

Params = dict

# weight leaves that live on crossbars as int8 conductance codes when serving
_QUANTIZABLE = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "unembed",
                "w_z", "w_x", "w_B", "w_C", "w_dt", "out_proj"}

_STACKS = ("blocks", "encoder", "decoder")  # gathered a layer at a time

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def quantize_model_params(params: Params) -> Params:
    """Weight matrices -> resident int8 codes + per-column scales.

    The reference runs this eagerly, so its ``/ 127.0`` is a true division
    (a jitted graph would multiply by the reciprocal); ``wo`` contracts over
    (heads, head_dim). A ``moe`` subtree (router and experts) stays float:
    the same tensor objects come back, as in the reference. A placed
    leaf is gathered and quantized whole (a resident weight replicates);
    the leaves left float keep their placement.
    """
    def q2d(leaf, name):
        if isinstance(leaf, Placed):  # quantized whole: codes replicate
            leaf = leaf.gather(leaf.devices[0])
        arr = leaf.float()
        if name == "wo":
            arr = arr.reshape(-1, arr.shape[-1])
        flat = arr.reshape(arr.shape[0], -1)                 # (K, N)
        amax = flat.abs().amax(dim=0, keepdim=True)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        codes = torch.clamp(torch.round(flat / scale), -128, 127).to(torch.int8)
        return layers.QuantizedWeight(codes, scale.float(), tuple(arr.shape[1:]))

    def walk(tree):
        if isinstance(tree, dict):
            return {name: (q2d(leaf, name) if name in _QUANTIZABLE
                           and isinstance(leaf, (torch.Tensor, Placed))
                           and len(leaf.shape) >= 2
                           else leaf if name == "moe"
                           else walk(leaf)) for name, leaf in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(x) for x in tree)
        return tree

    return walk(params)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """An encoder-decoder's encoder stack: bidirectional attention, dense
    FFNs, ``n_encoder_layers`` of them."""
    return cfg.replace(causal=False, mixer_pattern=("attn",),
                       ffn_pattern=("dense",))


def params_to(params, device):
    """Move a parameter tree (tensors and resident weights) to ``device``;
    a placed leaf comes whole onto it."""
    if isinstance(params, Placed):
        return params.gather(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(x, device) for x in params)
    if isinstance(params, (torch.Tensor, layers.QuantizedWeight)):
        return params.to(device)
    return params


def batch_axis(key: str, value) -> int:
    """The batch dimension of a batch entry: 1 for M-RoPE's (3, B, S)
    ``positions``, else 0."""
    return 1 if key == "positions" and value.ndim == 3 else 0


_TP_SLOTS = ("matmul", "activation", "softmax", "attention_prefill",
             "lm_head")


class Model:
    def __init__(self, cfg: ModelConfig,
                 exec_cfg: "ExecConfig | ExecPlan" = ExecConfig(),
                 device=None, mesh_ctx: Optional[MeshContext] = None):
        self.cfg = cfg
        self.plan = as_plan(cfg, exec_cfg)
        self.exec_cfg = self.plan.exec_cfg
        self.mesh_ctx = mesh_ctx if mesh_ctx is not None \
            and mesh_ctx.mesh is not None else None
        if self.mesh_ctx is None:
            self.device = resolve_device(device)
            return
        self._groups = replica_groups(self.mesh_ctx.mesh)
        self.device = self._groups[0].device
        off = [f"{slot}={self.plan.backend(slot)}" for slot in _TP_SLOTS
               if self.plan.backend(slot) != "digital"]
        if off:
            raise NotImplementedError(
                f"the mesh's compute covers the digital plan the train step "
                f"runs; this plan has {', '.join(off)}")

    @property
    def param_dtype(self):
        return _DTYPES[self.cfg.param_dtype]

    @property
    def compute_dtype(self):
        return _DTYPES[self.cfg.compute_dtype]

    def init(self, gen: torch.Generator) -> Params:
        """Fresh weights with the reference's distributions, drawn from
        ``gen`` (a generator on this model's device)."""
        cfg, dev, dt = self.cfg, self.device, self.param_dtype
        p = {"embed": layers.init_embeddings(gen, cfg, dev, dt),
             "final_norm": layers.init_norm(cfg, dev, dt)}
        if cfg.is_encoder_decoder:
            p["encoder"] = blocks.init_stack(gen, encoder_config(cfg), dev,
                                             dt, n_layers=cfg.n_encoder_layers)
            p["enc_norm"] = layers.init_norm(cfg, dev, dt)
            p["decoder"] = blocks.init_stack(gen, cfg, dev, dt, cross=True)
        else:
            p["blocks"] = blocks.init_stack(gen, cfg, dev, dt)
        return p

    def init_cache(self, batch: int, max_len: int, dtype=None):
        """A contiguous KV cache: (batch, L, KV, hd) buffers and a scalar
        write index per layer; L is max_len for a global layer and
        min(max_len, window) for a local layer's ring. An encoder-decoder's
        is ``{"dec": [...], "enc_kv": [(k, v)] * n_layers}``, the cross
        keys and values (batch, encoder_len, KV, hd) zeros until `prefill`
        is given ``enc_feats``."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        dec = blocks.init_stack_cache(cfg, batch, max_len, self.device, dtype)
        if not cfg.is_encoder_decoder:
            return dec
        shape = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        zeros = lambda: torch.zeros(shape, device=self.device, dtype=dtype)
        return {"dec": dec,
                "enc_kv": [(zeros(), zeros()) for _ in range(cfg.n_layers)]}

    def init_slot_cache(self, n_slots: int, max_len: int, dtype=None,
                        page_size: Optional[int] = None,
                        n_pages: Optional[int] = None) -> list:
        """A slot-pool cache for continuous batching.

        Without pages: `init_cache`'s (n_slots, L, KV, hd) buffers (rings
        for local layers) with a (n_slots,) write index per layer, one per
        slot, so every row fills and retires on its own. With
        ``page_size``/``n_pages`` (global-attention stacks only): every
        attention layer gets an (n_pages, page_size, KV, hd) pool shared by
        all slots (page 0 is the trash page) and a (n_slots,) fill vector;
        ``max_len`` then documents intent, capacity follows the block table
        the caller threads in. Mamba layers keep one state row per slot and
        no write index. Encoder-decoder stacks have no slot-pool form."""
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "slot-pool caches cover decoder-only stacks; encoder-"
                "decoder serving stays on bucketed batching")
        if page_size is None:
            cache = self.init_cache(n_slots, max_len, dtype)
            for layer in cache:
                if "attn" in layer:
                    layer["attn"]["idx"] = torch.zeros(
                        (n_slots,), dtype=torch.int32, device=self.device)
            return cache
        return blocks.init_stack_cache(self.cfg, n_slots, max_len,
                                       self.device,
                                       dtype or self.compute_dtype,
                                       page_size, n_pages)

    def _local(self, params: Params) -> Params:
        """``params`` with every entry but the layer stacks gathered onto
        this model's device when the tree is placed (embeddings, norms,
        the lm head); a tree that is not placed comes back as it is."""
        if not is_placed(params.get("embed")):
            return params
        return {k: (v if k in _STACKS else gather_tree(v, self.device))
                for k, v in params.items()}

    def _positions(self, tokens: torch.Tensor, offset=0) -> torch.Tensor:
        b, s = tokens.shape[:2]
        pos = torch.arange(s, dtype=torch.int32, device=tokens.device) + offset
        return pos.expand(b, s)

    def _encode(self, params: Params, enc_feats: torch.Tensor) -> torch.Tensor:
        """The encoder stack over stub-frontend frame embeddings (B,
        encoder_len, d_model): no positional embedding, then ``enc_norm``."""
        x = enc_feats.to(device=self.device, dtype=self.compute_dtype)
        x, _ = blocks.apply_stack(params["encoder"], x,
                                  cfg=encoder_config(self.cfg),
                                  plan=self.plan,
                                  positions=self._positions(x[..., 0]),
                                  caches=None)
        return layers.apply_norm(params["enc_norm"], x, self.cfg)

    def _enc_kv(self, params: Params, enc_out: torch.Tensor) -> list:
        """Each decoder layer's cross (k, v) from the encoder output,
        through the plan's matmul slot, with biases."""
        proj = lambda c, w, b: layers._linear(enc_out, c[w], self.plan,
                                              c.get(b))
        cross = [gather_tree(lp["cross"], enc_out.device)
                 for lp in params["decoder"]]
        return [(proj(c, "wk", "bk"), proj(c, "wv", "bv")) for c in cross]

    def _trunk(self, params, tokens, positions, cache, pad_lens=None,
               pad_prompt_len=None, slot_lens=None, block_table=None,
               page_size=None, chunk_offs=None, enc_feats=None,
               use_remat=False):
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens,
                         positions if positions.ndim == 2 else positions[0],
                         cfg)
        x = x.to(self.compute_dtype)
        if cfg.is_encoder_decoder:
            if cache is not None:  # cached cross k/v (prefill, decode)
                enc_kv = cache["enc_kv"]
            else:
                enc_kv = self._enc_kv(params, self._encode(params, enc_feats))
            x, new_dec = blocks.apply_stack(
                params["decoder"], x, cfg=cfg, plan=self.plan,
                positions=positions,
                caches=cache["dec"] if cache is not None else None,
                pad_lens=pad_lens, pad_prompt_len=pad_prompt_len,
                slot_lens=slot_lens, enc_kv=enc_kv)
            new_cache = (None if cache is None
                         else {"dec": new_dec, "enc_kv": enc_kv})
        else:
            x, new_cache = blocks.apply_stack(
                params["blocks"], x, cfg=cfg, plan=self.plan,
                positions=positions, caches=cache, pad_lens=pad_lens,
                pad_prompt_len=pad_prompt_len, slot_lens=slot_lens,
                block_table=block_table, page_size=page_size,
                chunk_offs=chunk_offs, use_remat=use_remat)
        return layers.apply_norm(params["final_norm"], x, cfg), new_cache

    def forward(self, params: Params, batch: dict,
                use_remat: bool = True) -> torch.Tensor:
        """Logits (B, S, V) of a whole sequence, no cache: the entry point
        of encoder-only models and of training. ``batch`` holds ``tokens``
        (B, S), optional ``positions`` (B, S) or (3, B, S) (M-RoPE), and
        ``enc_feats`` (B, encoder_len, d_model) for an encoder-decoder.
        ``use_remat`` checkpoints a decoder-only stack's layers when
        autograd records (`blocks.apply_stack`), as the reference's does;
        the numbers do not change. Under a ``mesh_ctx`` the logits come
        whole onto this model's device."""
        if self.mesh_ctx is not None:
            return self._mesh_forward(params, batch, use_remat)
        params = self._local(params)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        positions = batch.get("positions")
        positions = (self._positions(tokens) if positions is None
                     else torch.as_tensor(positions, device=self.device))
        enc_feats = batch.get("enc_feats")
        if enc_feats is not None:
            enc_feats = torch.as_tensor(enc_feats, device=self.device)
        x, _ = self._trunk(params, tokens, positions, None,
                           enc_feats=enc_feats, use_remat=use_remat)
        return layers.unembed(params["embed"], x, self.cfg, self.plan)

    def loss_fn(self, params: Params, batch: dict,
                use_remat: bool = True) -> torch.Tensor:
        """Next-token cross entropy, the mean over tokens that
        ``batch["loss_mask"]`` (optional, (B, S)) keeps: logsumexp minus
        the gold logit, in float32. A decoder predicts token t + 1 from
        position t; an encoder-only model predicts each token at its own
        position."""
        nll, count = self.loss_sums(params, batch, use_remat=use_remat)
        return nll / torch.clamp_min(count, 1.0)

    def loss_sums(self, params: Params, batch: dict,
                  use_remat: bool = True):
        """(the sum of `loss_fn`'s masked token losses, the count of kept
        tokens), float32: a data replica's part of a mesh step's mean (with
        a ``mesh_ctx``, the whole batch's over its replicas)."""
        if self.mesh_ctx is not None:
            return self._mesh_loss_sums(params, batch, use_remat)
        logits = self.forward(params, batch, use_remat=use_remat)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        if self.cfg.causal:
            targets = tokens[:, 1:]
            logits = logits[:, :-1]
        else:
            targets = tokens
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=self.device)
        else:
            mask = torch.as_tensor(mask, device=self.device)[
                :, -targets.shape[1]:].float()
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
        nll = (logz - gold) * mask
        return nll.sum(), mask.sum()

    # ------------------------------------------------------ the mesh
    def _replica_batches(self, batch: dict) -> list:
        """The batch's rows split over the data replicas, each part where
        the batch was (a replica's positions take it with
        `TPGroup.local`); M-RoPE's (3, B, S) positions split on B."""
        n = len(self._groups)
        rows = torch.as_tensor(batch["tokens"]).shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data replicas")
        parts = [{} for _ in range(n)]
        for k, v in batch.items():
            v = torch.as_tensor(v)
            for part, chunk in zip(parts, v.chunk(n, batch_axis(k, v))):
                part[k] = chunk
        return parts

    def _mesh_loss_sums(self, params, batch: dict, use_remat: bool):
        nll = count = None
        for group, part in zip(self._groups, self._replica_batches(batch)):
            s, c = self._tp_loss_sums(params, part, group, use_remat)
            nll = s if nll is None else nll + s.to(nll.device)
            count = c if count is None else count + c.to(count.device)
        return nll, count

    def _mesh_forward(self, params, batch: dict, use_remat: bool):
        outs = []
        for group, part in zip(self._groups, self._replica_batches(batch)):
            xs, sp = self._tp_trunk(params, part, group, use_remat)
            logits, vocab = self._tp_logits(params, xs, sp, group,
                                            part["tokens"].shape[1])
            outs.append(all_gather(logits, 2 if vocab else 1)[0])
        return torch.cat([o.to(self.device) for o in outs], 0)

    def _tp_trunk(self, params, batch: dict, group, use_remat: bool):
        """A replica's trunk over its model positions, through the final
        norm: (each position's part of the stream, whether it is
        sequence-sharded)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"])
        positions = batch.get("positions")
        positions = (self._positions(tokens) if positions is None
                     else torch.as_tensor(positions))
        b, s = tokens.shape
        sp = group.split((b, s, cfg.d_model), ("batch", "sp_seq", None), 1)
        toks, poss = group.local(tokens), group.local(positions)
        xs = layers.embed_tp(params["embed"], toks,
                             [p if p.ndim == 2 else p[0] for p in poss],
                             cfg, group, sp)
        xs = [x.to(self.compute_dtype) for x in xs]
        norm = lambda p, parts: [layers.apply_norm(
            {k: group.read(v, m) for k, v in p.items()}, x, cfg)
            for m, x in enumerate(parts)]
        if cfg.is_encoder_decoder:
            enc = torch.as_tensor(batch["enc_feats"]).to(self.compute_dtype)
            ecfg = encoder_config(cfg)
            esp = group.split(tuple(enc.shape), ("batch", "sp_seq", None), 1)
            es = group.local(enc)
            es = blocks.apply_stack_tp(
                params["encoder"], group.take(es, 1) if esp else es,
                cfg=ecfg, plan=self.plan,
                positions=group.local(self._positions(enc[..., 0])),
                group=group, sp=esp)
            es = norm(params["enc_norm"], es)
            xs = blocks.apply_stack_tp(
                params["decoder"], xs, cfg=cfg, plan=self.plan,
                positions=poss, group=group, sp=sp,
                cross=all_gather(es, 1) if esp else es)
        else:
            xs = blocks.apply_stack_tp(params["blocks"], xs, cfg=cfg,
                                       plan=self.plan, positions=poss,
                                       group=group, sp=sp,
                                       use_remat=use_remat)
        return norm(params["final_norm"], xs), sp

    def _tp_logits(self, params, xs: list, sp: bool, group, s: int):
        """(each position's logits, whether they are vocab-parallel): its
        vocab rows over the whole sequence (of ``s``) when ``vocab``
        divides, else the whole vocab over its sequence rows
        (`TPGroup.rows`)."""
        table, vdim = layers._vocab_table(params["embed"], self.cfg)
        b, V = xs[0].shape[0], table.shape[vdim]
        if group.split((b, s, V), ("batch", None, "vocab"), 2):
            xf = all_gather(xs, 1) if sp else xs
            out = []
            for m, x in enumerate(xf):
                w = group.read(table, m, vdim, "lm_head")
                out.append(self.plan.lm_head(x, w.T if vdim == 0 else w))
            return out, True
        out = []
        for m, x in enumerate(xs):
            w = group.read(table, m, name="lm_head")
            out.append(self.plan.lm_head(
                x if sp else x[:, group.rows(s, m)],
                w.T if vdim == 0 else w))
        return out, False

    def _tp_loss_sums(self, params, batch: dict, group, use_remat: bool):
        """A replica's (token-loss sum, kept count) over its model
        positions. The targets and the mask are laid out by position (a
        decoder's last position masked), each position summing its rows.
        With vocab-parallel logits the cross entropy takes the global max
        and the all-reduced sum of exps, and the target's logit from the
        position holding it; autograd then sends each position only its
        slice of softmax minus one-hot."""
        tokens = torch.as_tensor(batch["tokens"]).long()
        b, s = tokens.shape
        xs, sp = self._tp_trunk(params, batch, group, use_remat)
        logits, vocab = self._tp_logits(params, xs, sp, group, s)
        mask = batch.get("loss_mask")
        mask = (torch.ones((b, s), dtype=torch.float32) if mask is None
                else torch.as_tensor(mask)[:, -s:].float())
        if self.cfg.causal:
            targets = torch.cat([tokens[:, 1:], tokens[:, :1]], 1)
            mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], 1)
        else:
            targets = tokens
        tgt, msk = group.local(targets), group.local(mask)
        if vocab:
            V = logits[0].shape[-1]
            top = all_max([lg.amax(-1) for lg in logits])
            sums = all_reduce([torch.exp(lg - t[..., None]).sum(-1)
                               for lg, t in zip(logits, top)])
            golds = []
            for m, (lg, t) in enumerate(zip(logits, tgt)):
                local = t - m * V
                hit = (local >= 0) & (local < V)
                golds.append(torch.where(hit, torch.take_along_dim(
                    lg, torch.where(hit, local, 0)[..., None], -1)[..., 0],
                    torch.zeros((), device=lg.device)))
            golds = all_reduce(golds)
            parts = [(torch.log(z) + t - g)[:, group.rows(s, m)]
                     * k[:, group.rows(s, m)]
                     for m, (z, t, g, k) in enumerate(zip(sums, top, golds,
                                                          msk))]
        else:
            parts = []
            for m, (lg, t, k) in enumerate(zip(logits, tgt, msk)):
                rows = group.rows(s, m)
                gold = torch.take_along_dim(lg, t[:, rows, None], -1)[..., 0]
                parts.append((torch.logsumexp(lg, -1) - gold) * k[:, rows])
        nll = all_reduce([p.sum() for p in parts])[0]
        return nll, mask.to(group.device).sum()

    def prefill(self, params: Params, tokens: torch.Tensor, cache,
                enc_feats=None, positions=None, pad_lens=None):
        """Process the prompt; returns last-position logits and the cache.

        ``pad_lens`` (B,) int32: per-row left-pad prefix lengths (bucketed
        serving). Real tokens sit at positions shifted down by their row's
        pad count (pad columns clip to 0), and attention masks the pad
        columns per row, so a request's prefill does not depend on its
        bucket-mates. ``positions`` may be (3, B, S) for M-RoPE. An
        encoder-decoder given ``enc_feats`` runs the encoder and fills the
        cache's cross keys and values, cast to the cache's dtype.
        """
        params = self._local(params)
        if positions is None:
            positions = self._positions(tokens)
            if pad_lens is not None:
                positions = torch.clamp(
                    positions - pad_lens[:, None].to(torch.int32), min=0)
        if self.cfg.is_encoder_decoder and enc_feats is not None:
            enc_kv = self._enc_kv(params, self._encode(params, enc_feats))
            cache = dict(cache, enc_kv=[
                (k.to(ck.dtype), v.to(cv.dtype))
                for (k, v), (ck, cv) in zip(enc_kv, cache["enc_kv"])])
        x, new_cache = self._trunk(params, tokens, positions, cache,
                                   pad_lens=pad_lens)
        return (layers.unembed(params["embed"], x[:, -1:], self.cfg, self.plan),
                new_cache)

    def decode_step(self, params: Params, token: torch.Tensor, cache: list,
                    slot_lens: Optional[torch.Tensor] = None,
                    block_table: Optional[torch.Tensor] = None,
                    page_size: Optional[int] = None, pad_lens=None,
                    pad_prompt_len=None):
        """token: (B, 1). Returns (logits (B, 1, V), cache).

        Contiguous caches (no ``slot_lens``): the new token sits at the
        cache's write index, less the row's pad count under ``pad_lens``.
        ``slot_lens`` (B,) counts row b's valid cache columns including the
        token decoded this step (0 = an empty slot, a dead row);
        ``block_table``/``page_size`` address a block-paged slot cache.
        """
        params = self._local(params)
        if slot_lens is not None:
            lens = slot_lens.to(torch.int32)
            positions = torch.clamp(lens - 1, min=0)[:, None].expand(
                token.shape)
        else:
            lens = None
            positions = self._cache_index(cache).to(torch.int32).expand(
                token.shape)
        if pad_lens is not None:
            positions = torch.clamp(
                positions - pad_lens[:, None].to(torch.int32), min=0)
        x, new_cache = self._trunk(params, token, positions, cache,
                                   pad_lens=pad_lens,
                                   pad_prompt_len=pad_prompt_len,
                                   slot_lens=lens, block_table=block_table,
                                   page_size=page_size)
        return layers.unembed(params["embed"], x, self.cfg, self.plan), new_cache

    def _cache_index(self, cache) -> torch.Tensor:
        """The write index of the first attention layer's cache (its max,
        per slot); zero for a stack with no attention layer."""
        for layer in cache["dec"] if isinstance(cache, dict) else cache:
            if "attn" in layer:
                idx = layer["attn"]["idx"]
                return idx.amax() if idx.ndim else idx
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def prefill_chunk(self, params: Params, tokens: torch.Tensor, cache: list,
                      chunk_offs: torch.Tensor, chunk_lens: torch.Tensor,
                      block_table: torch.Tensor, page_size: int):
        """Stream one prompt chunk per slot into the paged cache.

        tokens: (B, C); row b carries ``chunk_lens[b]`` prompt tokens for
        logical columns [chunk_offs[b], chunk_offs[b] + chunk_lens[b]).
        Returns (logits (B, 1, V) at each row's last fed position, cache).
        """
        params = self._local(params)
        offs = chunk_offs.to(torch.int32)
        feed = chunk_lens.to(torch.int32)
        positions = offs[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=tokens.device)[None, :]
        x, new_cache = self._trunk(params, tokens, positions, cache,
                                   slot_lens=offs + feed,
                                   block_table=block_table,
                                   page_size=page_size, chunk_offs=offs)
        last = torch.clamp(feed - 1, min=0).long()
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return (layers.unembed(params["embed"], x_last, self.cfg, self.plan),
                new_cache)
