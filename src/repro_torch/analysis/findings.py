"""Structured findings + the committed suppression file of the port.

The port of `repro.analysis.findings`, with the port's rule table. Every
analysis pass reports `Finding` records — one per violated proof
obligation or lint rule, each anchored to a real file:line so the CLI
output is clickable. Known-and-justified exceptions live in the committed
`analysis_suppressions_torch.txt` at the repo root (the reference's
`analysis_suppressions.txt` is the JAX package's own): one line per
exception with a mandatory justification. A suppression that matches no
current finding is *stale* and becomes a finding itself (rule SUP001), so
the file can only shrink when the code actually improves.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Optional

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_SUPPRESSION_FILE = REPO_ROOT / "analysis_suppressions_torch.txt"

# Rule registry (id -> one-line meaning). Keeping it here makes rule ids a
# closed set: a suppression naming an unknown rule is itself a finding.
RULES = {
    # kernelcheck — the CUDA launch plans and their index math
    "KC101": "launch plan out of bounds: a split covers a page or key run "
             "twice or never, a grid dimension exceeds CUDA's limits, a "
             "cooperative launch is not co-resident, or a key tile crosses "
             "its page",
    "KC105": "block-table column or key consulted past the live frontier "
             "or the table",
    "KC106": "dynamic shared memory exceeds the per-block opt-in limit",
    "KC107": "paged cache write routing violates the trash-page fence",
    "KC108": "page allocator can issue the trash page",
    "KC110": "paged operand prolog plan: a block reads past its page's "
             "live rows, a slab, q or a page's code rows are covered twice "
             "or never, or a grid exceeds CUDA's limits",
    # tracelint — AST lint
    "TL101": "host synchronisation on the decode path (.item(), .tolist(), "
             ".cpu(), .numpy(), int/float/bool of a tensor, a branch on a "
             "tensor, torch.cuda.synchronize)",
    "TL103": "shape-dependent fallback branch inside a registered backend impl",
    "TL104": "plan-cache key dataclass member unhashable or order-unstable",
    # plan_audit — dispatch totality
    "PA101": "plan resolution raised for an in-matrix config",
    "PA102": "capability predicate raised instead of returning a reason",
    "PA103": "slot chain does not terminate in the digital baseline",
    "PA104": "registered backend unreachable by any matrix config or override",
    "PA105": "backend name referenced in the port's docs missing from registry",
    "PA106": "override-order changes the resolve_plan cache key",
    # suppression hygiene
    "SUP001": "stale suppression: matches no current finding",
    "SUP002": "malformed suppression line",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    tool: str            # "kernelcheck" | "tracelint" | "plan_audit" | ...
    rule: str            # key of RULES
    path: str            # repo-relative file the finding anchors to
    line: int            # 1-based line number (0 = whole file)
    site: str            # stable anchor, e.g. "decode_paged_gqa:k"
    message: str
    severity: str = "error"   # "error" | "warn"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"[{self.rule}] {loc} ({self.site}) {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    path: str
    fragment: str        # substring matched against finding.site + message
    justification: str
    lineno: int

    def matches(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.path == self.path
                and (self.fragment in f.site or self.fragment in f.message))


def load_suppressions(path: Optional[pathlib.Path] = None,
                      ) -> tuple[list[Suppression], list[Finding]]:
    """Parse the suppression file; malformed lines come back as findings."""
    path = pathlib.Path(path) if path else DEFAULT_SUPPRESSION_FILE
    sups: list[Suppression] = []
    bad: list[Finding] = []
    if not path.exists():
        return sups, bad
    rel = _rel(path)
    for i, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split("|")]
        if len(parts) != 4 or not all(parts):
            bad.append(Finding("suppressions", "SUP002", rel, i, f"line {i}",
                               f"expected 'RULE | path | fragment | why', "
                               f"got {raw!r}"))
            continue
        rule, fpath, fragment, why = parts
        if rule not in RULES:
            bad.append(Finding("suppressions", "SUP002", rel, i, f"line {i}",
                               f"unknown rule {rule!r}"))
            continue
        sups.append(Suppression(rule, fpath, fragment, why, i))
    return sups, bad


def apply_suppressions(findings: Iterable[Finding],
                       suppressions: Iterable[Suppression],
                       suppression_path: Optional[pathlib.Path] = None,
                       ) -> tuple[list[Finding], list[Finding], list[Finding]]:
    """Split findings into (active, suppressed) and report stale suppressions.

    Returns (active, suppressed, stale) where `stale` are SUP001 findings
    for suppression lines that matched nothing.
    """
    suppressions = list(suppressions)
    findings = list(findings)
    hit = [False] * len(suppressions)
    active, suppressed = [], []
    for f in findings:
        matched = False
        for j, s in enumerate(suppressions):
            if s.matches(f):
                hit[j] = True
                matched = True
        (suppressed if matched else active).append(f)
    rel = _rel(pathlib.Path(suppression_path)
               if suppression_path else DEFAULT_SUPPRESSION_FILE)
    stale = [Finding("suppressions", "SUP001", rel, s.lineno,
                     f"{s.rule}|{s.fragment}",
                     f"suppression matches no current finding "
                     f"(justified as: {s.justification})")
             for j, s in enumerate(suppressions) if not hit[j]]
    return active, suppressed, stale


def _rel(path: pathlib.Path) -> str:
    try:
        return str(path.resolve().relative_to(REPO_ROOT))
    except ValueError:
        return str(path)


def render_report(active: list[Finding], suppressed: list[Finding],
                  stale: list[Finding], coverage: dict) -> str:
    out = []
    for title, group in (("FINDINGS", active), ("STALE SUPPRESSIONS", stale)):
        if group:
            out.append(f"== {title} ({len(group)}) ==")
            out += [f.render() for f in group]
    if suppressed:
        out.append(f"== suppressed ({len(suppressed)}, justified in "
                   f"{DEFAULT_SUPPRESSION_FILE.name}) ==")
        out += [f"  {f.render()}" for f in suppressed]
    out.append("== coverage ==")
    for k in sorted(coverage):
        out.append(f"  {k}: {coverage[k]}")
    verdict = "CLEAN" if not active and not stale else "FAIL"
    out.append(f"analysis: {verdict} ({len(active)} active finding(s), "
               f"{len(stale)} stale suppression(s), "
               f"{len(suppressed)} suppressed)")
    return "\n".join(out)


def to_json(active, suppressed, stale, coverage) -> str:
    return json.dumps({
        "active": [f.to_json() for f in active],
        "suppressed": [f.to_json() for f in suppressed],
        "stale": [f.to_json() for f in stale],
        "coverage": coverage,
    }, indent=2, sort_keys=True)
