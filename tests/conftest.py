import os

# smoke tests and benches must see 1 device (the dry-run sets its own flags
# in a separate process); keep CPU math deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import jax
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def analysis_results():
    """One shared `repro.analysis` run (the kernel capture re-traces every
    wrapper, ~a minute) — test_analysis.py and the test_docs.py contract
    sync check both read from here instead of re-running the passes."""
    from repro import analysis
    findings, coverage, contracts = analysis.run_all()
    sups, malformed = analysis.load_suppressions()
    active, suppressed, stale = analysis.apply_suppressions(findings, sups)
    return dict(findings=findings, coverage=coverage, contracts=contracts,
                malformed=malformed, active=active, suppressed=suppressed,
                stale=stale)


def tiny_config(cfg):
    """Reduced same-family config for per-arch smoke tests."""
    kw = dict(d_model=64, d_ff=128, vocab_size=256, param_dtype="float32",
              compute_dtype="float32", max_seq_len=128, window=8)
    P = cfg.block_period
    kw["n_layers"] = min(cfg.n_layers, 2 * P + (1 if cfg.n_layers % P else 0))
    if cfg.n_heads:
        kw.update(n_heads=4, head_dim=16,
                  n_kv_heads=(min(cfg.n_kv_heads, 2)
                              if cfg.n_kv_heads < cfg.n_heads else 4))
    if cfg.head_pad_to:
        kw["head_pad_to"] = 6
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), capacity_factor=8.0)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=8, ssm_chunk=8)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_len=12)
    return cfg.replace(**kw)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where there is none")
