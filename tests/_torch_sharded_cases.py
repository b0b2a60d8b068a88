"""The inputs of the tensor-parallel parity cases (numpy only: imported by
tests/_torch_sharded_child.py, which runs the reference's sharded paths,
and by the port's tests, which run the port's on the same arrays)."""
import numpy as np

OPS_MESHES = (2, 4)       # the reference's meshes (8 simulated devices)
PORT_MESHES = (1, 2, 4, 8)
B, SMAX, PS, N_PAGES, SQ, CHUNK = 2, 24, 8, 12, 12, 8
OPS_CONFIGS = {"mha": (8, 8, 128), "gqa": (16, 8, 256)}  # H, KV, d_model
DATAFLOWS = ("prefill_causal", "prefill_padded", "decode", "chunk",
             "paged_decode", "paged_chunk")


def config_kw(n_heads, n_kv_heads, d_model):
    """gpt2-large replacements of tests/_sharded_parity_child.py's configs
    (head dim 16)."""
    return dict(name=f"tp-parity-h{n_heads}kv{n_kv_heads}", n_layers=2,
                d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                d_ff=2 * d_model, vocab_size=256, pos_emb="rope",
                norm="rmsnorm", glu=False, qkv_bias=False,
                param_dtype="float32", compute_dtype="float32", remat="none",
                tie_embeddings=True)


def ops_inputs(tag):
    """Every dataflow's operands, numpy float32 / int32 / bool."""
    H, KV, d = OPS_CONFIGS[tag]
    hd = d // H
    rng = np.random.default_rng(len(tag))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    chunk_mask = lambda lens, n: (  # (B, CHUNK, n): the intra-chunk rule
        np.arange(n)[None, None, :]
        <= (lens - CHUNK)[:, None, None] + np.arange(CHUNK)[None, :, None])
    chunk_lens = np.array([SMAX - 4, CHUNK + 3], np.int32)
    pchunk_lens = np.array([3 * PS - 2, CHUNK + 2], np.int32)
    return {
        "q1": f(B, 1, H, hd), "k": f(B, SMAX, KV, hd), "v": f(B, SMAX, KV, hd),
        "kv_len": np.array([17, 9], np.int32),
        "qc": f(B, CHUNK, H, hd), "chunk_len": chunk_lens,
        "chunk_mask": chunk_mask(chunk_lens, SMAX),
        "kpool": f(N_PAGES, PS, KV, hd), "vpool": f(N_PAGES, PS, KV, hd),
        "block_table": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
        "pkv_len": np.array([3 * PS - 3, PS + 1], np.int32),
        "pchunk_len": pchunk_lens,
        "pchunk_mask": chunk_mask(pchunk_lens, 3 * PS),
        "qp": f(B, SQ, H, hd), "kp": f(B, SQ, KV, hd), "vp": f(B, SQ, KV, hd),
        "pad_lens": np.array([0, 3], np.int32),
    }


def ops_call(plan, name, x, scale):
    """Dataflow ``name`` through a plan of either package (``x`` holds
    that package's arrays)."""
    pool = dict(block_table=x["block_table"], page_size=PS)
    if name == "prefill_causal":
        return plan.attention_prefill(x["qp"], x["kp"], x["vp"], scale=scale,
                                      q_offset=0, kind="causal", window=None,
                                      chunk=None)
    if name == "prefill_padded":
        return plan.attention_prefill(x["qp"], x["kp"], x["vp"], scale=scale,
                                      q_offset=0, kind="causal", window=None,
                                      chunk=None, pad_lens=x["pad_lens"])
    if name == "decode":
        return plan.attention_decode(x["q1"], x["k"], x["v"],
                                     kv_len=x["kv_len"], scale=scale)
    if name == "chunk":
        return plan.attention_decode(x["qc"], x["k"], x["v"],
                                     kv_len=x["chunk_len"], scale=scale,
                                     pad_valid=x["chunk_mask"])
    if name == "paged_decode":
        return plan.attention_decode(x["q1"], x["kpool"], x["vpool"],
                                     kv_len=x["pkv_len"], scale=scale, **pool)
    if name == "paged_chunk":
        return plan.attention_decode(x["qc"], x["kpool"], x["vpool"],
                                     kv_len=x["pchunk_len"], scale=scale,
                                     pad_valid=x["pchunk_mask"], **pool)
    raise ValueError(name)


# ---------------------------------------------------------------------- moe

MOE_CASES = (  # (tag, model name, model-axis size, B, S)
    ("mixtral-tp-m2-prefill", "mixtral-8x22b", 2, 2, 8),
    ("mixtral-tp-m2-decode", "mixtral-8x22b", 2, 4, 1),
    ("scout-ep-m2-prefill", "llama4-scout-17b-a16e", 2, 2, 16),
    ("scout-ep-m2-decode", "llama4-scout-17b-a16e", 2, 4, 1),
    ("scout-ep-m4-prefill", "llama4-scout-17b-a16e", 4, 2, 16),
    ("scout-ep-m4-decode", "llama4-scout-17b-a16e", 4, 4, 1),
)
MOE_MODES = ("digital", "raceit")
MOE_CF = 1.25  # choices drop


def moe_inputs(case_index, B, S, D, E, F, glu):
    """Tokens that share a direction (they crowd the same experts, so
    choices drop at 1.25) at per-token scales, and the layer's weights at
    the reference's init scales."""
    rng = np.random.default_rng(100 + case_index)
    scale = rng.uniform(0.05, 1.0, (B, S, 1)).astype(np.float32)
    shared = rng.standard_normal((1, 1, D)).astype(np.float32)
    z = rng.standard_normal((B, S, D)).astype(np.float32)
    f = lambda fan, *s: (rng.standard_normal(s) / np.sqrt(fan)).astype(
        np.float32)
    p = {"router": f(D, D, E), "w1": f(E, E, D, F), "w2": f(F, E, F, D)}
    if glu:
        p["w3"] = f(E, E, D, F)
    return (z + shared) * scale, p


# -------------------------------------------------------- FSDP serving

FSDP_MESH = "data=2,model=2"
FSDP_MODELS = ("gpt2-large", "command-r-35b", "mixtral-8x22b")
FSDP_MAX_LEN = 64
FSDP_SEEDS = (0, 1)


def fsdp_prompts():
    """`generate`'s prompts: (2, 12) int32."""
    return np.random.default_rng(11).integers(0, 256, (2, 12)).astype(
        np.int32)


def fsdp_batcher_kw(paged):
    """The batcher of a trace: paged pages of 8 (the reference soak's), or
    the contiguous slot pool where the model has no paged form."""
    return (dict(n_slots=3, page_size=8, n_pages=13) if paged
            else dict(n_slots=3, prefill_len=24))


def fsdp_trace(seed, vocab_size):
    """A mixed-length trace, ``[(rid, prompt, n_new)]``: the reference
    soak's (tests/_sharded_parity_child.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(int(rng.integers(3, 6))):
        L = int(rng.integers(1, 24))
        prompt = np.random.default_rng(1000 + L).integers(
            0, vocab_size, size=L).tolist()
        out.append((rid, prompt, int(rng.integers(1, 5))))
    return out


def drive_trace(cb, requests, make_request):
    """Submit ``requests`` to either framework's `ContinuousBatcher` and
    step it dry, the page pool's invariants held after every step; the
    tokens by request id."""
    for rid, prompt, n_new in requests:
        cb.submit(make_request(rid, prompt, n_new=n_new))
    steps = 0
    while cb.queue or any(s is not None for s in cb.slots):
        cb.step()
        steps += 1
        assert steps < 500, "trace failed to drain"
        if cb.paged:
            cb.allocator.assert_invariants()
    return {rid: [int(t) for t in r.result] for rid, r in cb.done.items()}
