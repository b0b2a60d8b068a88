"""Static analysis of the port: proofs before the card.

The port of `repro.analysis`. Three passes, one CLI
(`python -m repro_torch.analysis --strict`):

* `kernelcheck` — the CUDA launch plans of the attention kernels and a
  mirror of their index math, over the serving domain (splits cover every
  page and key run once, no column past the live frontier, grid limits,
  co-residency, dynamic shared memory), and the paged write fence and
  page allocator.
* `tracelint`  — AST lint: host synchronisations on the decode path,
  shape fallbacks in backends, plan-cache key hygiene.
* `plan_audit` — exhaustive dispatch totality over the config matrix
  (no raises, digital termination, no dead backends, honest docs).

Findings are structured `findings.Finding` records with file:line
anchors; justified exceptions live in `analysis_suppressions_torch.txt`
at the repo root, and stale suppressions are findings themselves.
"""
from __future__ import annotations

from .findings import (DEFAULT_SUPPRESSION_FILE, Finding, RULES,
                       apply_suppressions, load_suppressions,
                       render_report, to_json)

__all__ = ["Finding", "RULES", "run_all", "load_suppressions",
           "apply_suppressions", "render_report", "to_json",
           "DEFAULT_SUPPRESSION_FILE"]


def run_all() -> tuple[list, dict, str]:
    """Run every pass: (findings, merged coverage, contracts markdown)."""
    from . import kernelcheck, plan_audit, tracelint

    kc_findings, kc_cov, contracts = kernelcheck.run()
    tl_findings, tl_cov = tracelint.run()
    pa_findings, pa_cov = plan_audit.run()
    coverage = {}
    for prefix, cov in (("kernelcheck", kc_cov), ("tracelint", tl_cov),
                        ("plan_audit", pa_cov)):
        for k, v in cov.items():
            coverage[f"{prefix}.{k}"] = v
    return kc_findings + tl_findings + pa_findings, coverage, contracts
