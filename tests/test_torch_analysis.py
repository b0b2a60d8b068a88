"""The port's static analysis (`repro_torch.analysis`) against the
reference's, and each rule on a seeded bad input.

* `python -m repro_torch.analysis --strict` exits 0 on this tree (every
  finding justified in analysis_suppressions_torch.txt, none stale), and
  its contract report is the committed docs/kernel_contracts_torch.md.
* plan_audit's coverage equals the reference's counts (13 models, 128
  exec configs, 1664 plans, 48,256 predicate calls, 29 backends, none
  unreachable).
* KC107 and KC108 give the reference's results on its domains: clean on
  the real routing helpers and allocator, and the same findings for the
  same broken router.
* The CUDA plan checks run over the serving domain with its sizes stated.
* KC101, KC105, KC106 and TL101 fire on seeded bad inputs: a plan whose
  splits leave pages uncovered, a block that reads past the frontier, a
  shared-memory layout over 227 KiB, a ``.item()`` in a backend.
"""
import json
import textwrap
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_helpers  # noqa: E402,F401  (one torch thread a worker)

import jax.numpy as jnp  # noqa: E402

from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import kernelcheck as KC  # noqa: E402
from repro_torch.analysis import tracelint  # noqa: E402
from repro_torch.kernels import acam_attention as A  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def strict_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("analysis") / "contracts.md"
    buf = StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--strict", "--json", "--write-contracts", str(out)])
    return rc, json.loads(buf.getvalue()), out.read_text()


def test_strict_run_is_clean(strict_run):
    rc, report, _ = strict_run
    assert rc == 0
    assert report["active"] == [] and report["stale"] == []
    sups = [line for line in (ROOT / "analysis_suppressions_torch.txt")
            .read_text().splitlines()
            if line.strip() and not line.startswith("#")]
    assert len(report["suppressed"]) >= len(sups)
    for line in sups:
        assert len(line.split("|")[3].strip()) > 40   # a real reason


def test_contracts_report_in_sync(strict_run):
    _, _, contracts = strict_run
    assert contracts == (ROOT / "docs" / "kernel_contracts_torch.md").read_text()


def test_plan_audit_coverage_matches_reference(strict_run):
    from repro.analysis import plan_audit as rplan_audit
    _, report, _ = strict_run
    cov = report["coverage"]
    _, rcov = rplan_audit.run()
    for k in ("models", "exec_configs", "plans_resolved", "predicate_calls",
              "backends", "unreachable"):
        assert cov[f"plan_audit.{k}"] == rcov[k], k
    assert (cov["plan_audit.models"], cov["plan_audit.exec_configs"],
            cov["plan_audit.plans_resolved"], cov["plan_audit.backends"],
            cov["plan_audit.unreachable"]) == (13, 128, 1664, 29, [])


def test_cuda_plan_domain_is_stated(strict_run):
    _, report, _ = strict_run
    cov = report["coverage"]
    assert cov["kernelcheck.max_len"] == 512
    assert cov["kernelcheck.page_sizes"] == 32 + 15     # 1..32, 64..512
    assert cov["kernelcheck.head_dim"] == 320
    assert cov["kernelcheck.group_counts"] > 20
    assert cov["kernelcheck.plans"] > 10_000
    assert cov["kernelcheck.block_checks"] > 1_000_000
    assert cov["kernelcheck.smem_max"] <= KC.SMEM_OPTIN
    assert cov["tracelint.reached_functions"] > 100


# ------------------------------------------------------- KC107 and KC108

def test_write_fence_and_allocator_match_reference():
    from repro.analysis import kernelcheck as rkc
    assert rkc.check_write_fence() == [] and KC.check_write_fence() == []
    assert rkc.check_allocator() == [] and KC.check_allocator() == []

    def never_trash_ref(bt, lens, offs, sq, ps):   # ignores liveness
        cols = offs[:, None] + jnp.arange(sq)[None, :]
        page = jnp.take_along_axis(bt, jnp.minimum(cols // ps,
                                                   bt.shape[1] - 1), 1)
        return page, cols % ps

    def never_trash(bt, lens, offs, sq, ps):
        cols = offs.long()[:, None] + torch.arange(sq)[None, :]
        page = torch.take_along_dim(bt.long(), torch.clamp(
            cols // ps, max=bt.shape[1] - 1), 1)
        return page, cols % ps
    want = rkc.check_write_fence(route_chunk=never_trash_ref)
    got = KC.check_write_fence(route_chunk=never_trash)
    assert len(got) == len(want) == 1
    assert (got[0].rule, got[0].site, got[0].message) == (
        want[0].rule, want[0].site, want[0].message)

    from repro_torch.serve.paged import PageAllocator

    class Leaky(PageAllocator):
        def alloc(self, slot, n):
            pages = super().alloc(slot, n)
            return None if pages is None else pages[:-1] + [0]
    found = KC.check_allocator(Leaky)
    assert found and all(f.rule == "KC108" for f in found)


# ------------------------------------------------------ seeded bad inputs

def test_kc101_uncovered_pages():
    plan = A.paged_plan(8, 1, 20, 16)
    bad = type(plan)(**{**plan.__dict__, "splits": plan.splits - 1})
    found = KC.check_paged_plan(8, 1, 128, 20, 16, plan=bad)
    assert [f.rule for f in found] == ["KC101"]
    assert "do not cover" in found[0].message
    assert KC.check_paged_plan(8, 1, 128, 20, 16) == []


def test_kc101_key_tile_and_co_residency():
    plan = A.paged_plan(8, 1, 4, 64)
    bad = type(plan)(**{**plan.__dict__, "key_tile": 48})
    assert {f.rule for f in KC.check_paged_plan(8, 1, 128, 4, 64,
                                                plan=bad)} == {"KC101"}
    plan = A.single_plan(8, 16, 200)
    bad = type(plan)(**{**plan.__dict__, "units": 100, "splits": 2,
                        "per": plan.runs})
    found = KC.check_contiguous_plan(8, 16, 200, 128, plan=bad, single=True)
    assert any("co-resident" in f.message for f in found)


def test_kc105_reads_past_the_frontier():
    def unclamped(plan, split, length, page_size):   # no min(.., npages)
        j0 = split * plan.pages_per_split
        return j0, j0 + plan.pages_per_split
    found = KC.check_paged_plan(8, 1, 128, 20, 16, slice_fn=unclamped)
    assert [f.rule for f in found] == ["KC105"]
    assert "past the live frontier" in found[0].message


def test_kc106_shared_memory_over_the_limit():
    plan = A.paged_plan(8, 1, 20, 16)
    bad = type(plan)(**{**plan.__dict__, "pages_per_split": 60_000})
    found = [f for f in KC.check_paged_plan(8, 1, 128, 20, 16, plan=bad)
             if f.rule == "KC106"]
    assert found and "opt-in limit" in found[0].message
    assert KC.smem_paged(0, 1, 128, 16, 20, False, 60_000, 16) > \
        KC.SMEM_OPTIN
    assert KC.smem_contiguous(0, 64, 512, 320, 512, True, 16) <= \
        KC.SMEM_OPTIN


def test_tl101_item_in_a_backend(tmp_path):
    pkg = tmp_path / "exec"
    pkg.mkdir()
    (pkg / "backends.py").write_text(textwrap.dedent('''
        import torch
        from .registry import register


        def _helper(x: torch.Tensor):
            return int(x.sum())


        @register("softmax", "raceit_bad")
        def _softmax_bad(plan, logits, axis):
            top = logits.amax().item()
            if (logits > 0).any():
                logits = logits - top
            return logits / _helper(logits)


        @register("softmax", "raceit_good")
        def _softmax_good(plan, logits, axis):
            n = logits.shape[-1]
            if n > 8 and logits is not None:
                return logits / n
            return logits
    '''))
    found, stats = tracelint.run(root=tmp_path)
    tl = sorted((f.site, f.line) for f in found if f.rule == "TL101")
    assert tl == [("_helper", 7), ("_softmax_bad", 12),
                  ("_softmax_bad", 13)], found
    assert stats["reached_functions"] == 3


def test_tl101_numpy_is_not_a_sync():
    import ast
    src = textwrap.dedent('''
        def f(a: torch.Tensor, b):
            s = np.cumsum(b).tolist()
            n = len(a.shape)
            if a is None or a.ndim > 2:
                return s
            return a.cpu()
    ''')
    fn = ast.parse(src).body[0]
    found = tracelint.lint_host_syncs(fn, "x.py")
    assert [(f.line, f.message) for f in found] == [
        (7, "host sync: `.cpu()` (a)")]
