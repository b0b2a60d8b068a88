"""The paged attention entries' operand prolog on the card.

`raceit_attention_decode_paged` and `raceit_attention_decode_gqa_paged`
(`repro_torch.kernels.ops`) quantize q (one int8 scale over the tensor) and
the live rows of a block-paged K/V pool (one scale each, over the union of
the pages' live rows), and hand the paged kernels the K/V codes in their
stripe row layout. On the card that is ``csrc/acam_prolog.cu``: two
launches over the live pages, no host synchronisation; `launch_prolog`
runs them, on the operands as `operands` brings them. On the CPU and on
``meta`` the torch composition `repro_torch.kernels.ops.paged_operands_plain`
runs, the kernels' plain version, and the card's codes and scales equal it
bit for bit.

`prolog_plan` is the host plan of both launches (its blocks and what each
takes), which `repro_torch.analysis.kernelcheck` checks over the serving
domain. The launches share a per-device workspace of ``4 + n_pages`` int32
words that the quantise launch's last block leaves zeroed, so a call needs
no fill launch; calls on one device run on one stream at a time.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PROLOG_CHUNK", "PROLOG_THREADS", "POOL_DTYPES", "PrologPlan",
           "prolog_plan", "operands", "launch_prolog", "launches"]

# elements of a page slab (its rows x KV heads x head dim) or of q that
# one block takes, and the threads of a block (csrc/acam_prolog.cu)
PROLOG_CHUNK = 8192
PROLOG_THREADS = 256
# the pool dtypes the kernels read (bfloat16 widens exactly in the kernels)
POOL_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches, one per launch of csrc/acam_prolog.cu
launches = {"acam_prolog": 0}

_WORKSPACE: dict = {}


@dataclasses.dataclass(frozen=True)
class PrologPlan:
    """The blocks of both launches: ``slab_blocks`` blocks a page slab of
    ``slab`` elements, ``chunk`` elements each, and ``q_blocks`` blocks over
    the ``n_q`` elements of q after the page blocks. The max launch's page
    blocks take block-table entries, the quantise launch's physical
    pages."""
    chunk: int
    slab: int
    slab_blocks: int
    q_blocks: int
    grid_max: int
    grid_quant: int


def prolog_plan(n_slots: int, max_pages: int, n_pages: int, page_size: int,
                kv_heads: int, head_dim: int, n_q: int) -> PrologPlan:
    slab = page_size * kv_heads * head_dim
    slab_blocks = -(-slab // PROLOG_CHUNK)
    q_blocks = -(-n_q // PROLOG_CHUNK)
    return PrologPlan(PROLOG_CHUNK, slab, slab_blocks, q_blocks,
                      n_slots * max_pages * slab_blocks + q_blocks,
                      n_pages * slab_blocks + q_blocks)


def operands(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor):
    """q and the pools as the kernels take them: float32 q (B, H, Sq, D)
    with its head dim contiguous, and contiguous pools (n_pages, page_size,
    KV, D) of one shape and one dtype of `POOL_DTYPES`, on q's device.
    Pools of another dtype, or of two dtypes, widen to float32, as the
    plain version reads them (exact). q of another dtype is refused: the
    plain version quantizes it in its own precision."""
    if q.dtype != torch.float32:
        raise TypeError(f"the prolog quantizes float32 q, got {q.dtype}")
    if (q.ndim != 4 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape
            or q.shape[3] != k_pool.shape[3]):
        raise ValueError(f"prolog operands: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if not k_pool.device == q.device == v_pool.device:
        raise ValueError(f"prolog operands on {q.device}, {k_pool.device} "
                         f"and {v_pool.device}")
    if k_pool.dtype != v_pool.dtype or k_pool.dtype not in POOL_DTYPES:
        k_pool, v_pool = k_pool.float(), v_pool.float()
    if not _last_dim_dense(q):
        q = q.contiguous()
    return q, k_pool.contiguous(), v_pool.contiguous()


def _last_dim_dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s last dim has stride 1 (host metadata, no sync)."""
    return t.stride(-1) == 1


def _workspace(dev: torch.device, n_pages: int) -> torch.Tensor:
    """The device's zeroed workspace words (at least ``4 + n_pages``)."""
    ws = _WORKSPACE.get(dev)
    if ws is None or ws.numel() < 4 + n_pages:
        ws = torch.zeros((4 + n_pages,), dtype=torch.int32, device=dev)
        _WORKSPACE[dev] = ws
    return ws


def launch_prolog(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor, kv_len: torch.Tensor, rep: int):
    """Both launches on the current stream.

    q (B, H, Sq, D) float32; k/v pools (n_pages, page_size, KV, hd), read
    as `operands` brings them; ``block_table`` (n_slots, max_pages) and
    ``kv_len`` (n_slots,) int32, contiguous. Returns q's codes (B, H, Sq, D), the K and V codes
    (n_pages * KV * rep, page_size, hd) int8 (rows of pages no block-table
    entry names are left unwritten) and the stats (6,) float32: the clamped
    amax of q, K, V, then their scales.
    """
    import ctypes

    from .build import bind  # built at first launch, never at import
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = bind("acam_prolog", "acam_prolog_launch",
              [P, LL, LL, LL, I, I, I, I, P, P, I, I, I, I, I, I, P, P, I, I,
               P, P, P, P, P, I, I, LL, P])
    q, k_pool, v_pool = operands(q, k_pool, v_pool)
    B, H, Sq, D = q.shape
    n_pages, ps, KV, hd = k_pool.shape
    n_slots, max_pages = block_table.shape
    dev = q.device
    for name, t in (("block_table", block_table), ("kv_len", kv_len)):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if kv_len.shape != (n_slots,):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} for {n_slots} "
                         f"slots")
    plan = prolog_plan(n_slots, max_pages, n_pages, ps, KV, hd, q.numel())
    qc = torch.empty((B, H, Sq, D), dtype=torch.int8, device=dev)
    kc = torch.empty((n_pages * KV * rep, ps, hd), dtype=torch.int8,
                     device=dev)
    vc = torch.empty_like(kc)
    stats = torch.empty((6,), dtype=torch.float32, device=dev)
    ws = _workspace(dev, n_pages)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), *q.stride()[:3], B, H, Sq, D, k_pool.data_ptr(),
             v_pool.data_ptr(), int(k_pool.dtype == torch.bfloat16), n_pages,
             ps, KV, hd, rep, block_table.data_ptr(), kv_len.data_ptr(),
             n_slots, max_pages, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
             stats.data_ptr(), ws.data_ptr(), plan.chunk, plan.slab_blocks,
             plan.q_blocks, stream)
    if err != 0:
        raise RuntimeError(f"acam_prolog launch failed: cudaError {err}")
    launches["acam_prolog"] += 2
    return qc, kc, vc, stats
