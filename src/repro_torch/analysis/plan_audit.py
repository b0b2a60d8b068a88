"""Dispatch-totality audit of the port: the registry/plan layer is total
and live.

The port of `repro.analysis.plan_audit`, over the port's registry, plan,
catalog, `NoiseConfig` and `MeshSpec`. Exhaustively resolves execution
plans over the full declarative matrix —
every `configs.catalog` architecture x mode x fused x softmax flavor x
matmul fidelity x device-noise preset — and audits the result:

PA101 — `resolve_plan` must never raise for an in-matrix config
    (degrades are recorded on the plan, never thrown).
PA102 — no capability predicate may raise: `supported(mcfg, ecfg)`
    returns None or a reason string for every registered backend against
    every matrix pair.
PA103 — every slot chain terminates in the digital baseline: the
    baseline backend exists, its predicate accepts every matrix pair, and
    every resolved plan populates every slot.
PA104 — every registered backend is *reachable*: some matrix config
    (directly or via a one-slot `op_overrides` pin) resolves to it. A
    backend nothing can reach is dead registration — a finding.
PA105 — every backend-style name (`raceit_*`) mentioned in README's
    section on the port exists in the port's registry or its public
    kernel API; docs must not advertise backends that don't exist.
PA106 — override order must not change the plan-cache key: two
    `ExecConfig`s carrying the same pins in different orders must be
    equal and hash-equal (else the lru cache silently doubles).
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import pathlib
import re
import warnings
from typing import Optional

from .findings import REPO_ROOT, Finding


def _anchor(obj) -> tuple[str, int]:
    try:
        path = inspect.getsourcefile(obj)
        line = inspect.getsourcelines(obj)[1]
        return str(pathlib.Path(path).resolve().relative_to(REPO_ROOT)), line
    except (TypeError, OSError, ValueError):
        return "src/repro_torch/exec/plan.py", 0


def _matrix():
    from ..configs import get_config
    from ..configs.base import ExecConfig
    from ..configs.catalog import ASSIGNED, PAPER_OWN
    from ..dist import MeshSpec
    from ..hw.noise import NoiseConfig

    models = [get_config(n) for n in list(ASSIGNED) + list(PAPER_OWN)]
    noise = NoiseConfig.preset("nominal")
    # mesh axis: resolution is device-independent (predicates only read
    # MeshSpec.model_size; nothing builds the mesh), so the audit covers
    # the sharded raceit_*_tp chains — including the model=3 non-divisor
    # degrade and a data+model mesh — on a 1-device host.
    meshes = (None, MeshSpec.parse("model=4"), MeshSpec.parse("model=3"),
              MeshSpec.parse("data=2,model=2"))
    execs = []
    seen = set()
    for mode, fused, softmax, fidelity, nz, mesh in itertools.product(
            ("digital", "raceit"), (False, True), ("pot", "uniform"),
            ("int", "acam"), (None, noise), meshes):
        ec = ExecConfig(mode=mode, fused_attention=fused,
                        softmax_mode=softmax, matmul_fidelity=fidelity,
                        noise=nz, mesh=mesh)
        if ec not in seen:
            seen.add(ec)
            execs.append(ec)
    return models, execs


def _describe(mcfg, ecfg) -> str:
    nz = "none" if ecfg.noise is None else "nominal"
    mesh = "none" if ecfg.mesh is None else ecfg.mesh.describe()
    return (f"{mcfg.name}/mode={ecfg.mode},fused={ecfg.fused_attention},"
            f"softmax={ecfg.softmax_mode},fidelity={ecfg.matmul_fidelity},"
            f"noise={nz},mesh={mesh}")


def run() -> tuple[list[Finding], dict]:
    # in-matrix degrades (fused+noise, fused+acam, ...) are expected and
    # recorded on the plans; their one-time warnings are not audit output
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=RuntimeWarning,
                                message=".*falling back.*")
        return _run()


def _run() -> tuple[list[Finding], dict]:
    from ..exec.plan import _BASELINE, resolve_plan, reset_plan_cache
    from ..exec.registry import OP_SLOTS, get_backend, list_backends

    findings: list[Finding] = []
    models, execs = _matrix()
    backends = list_backends()      # slot -> {name: spec}, forces import
    reset_plan_cache()

    plan_path, plan_line = _anchor(resolve_plan)

    # --- PA101/PA103: total resolution, every slot lands somewhere -------
    plans = 0
    for mcfg in models:
        for ecfg in execs:
            try:
                plan = resolve_plan(mcfg, ecfg)
                plans += 1
            except Exception as e:   # noqa: BLE001 — the audit's whole point
                findings.append(Finding(
                    "plan_audit", "PA101", plan_path, plan_line,
                    _describe(mcfg, ecfg),
                    f"resolve_plan raised {type(e).__name__}: {e}"))
                continue
            missing = [s for s in OP_SLOTS if s not in
                       {op.slot for op in plan.ops}]
            if missing:
                findings.append(Finding(
                    "plan_audit", "PA103", plan_path, plan_line,
                    _describe(mcfg, ecfg),
                    f"resolved plan is missing slots {missing}"))

    # --- PA102/PA103: predicates never raise; baselines always accept ----
    pred_calls = 0
    for slot, named in sorted(backends.items()):
        base_name = _BASELINE[slot][0]
        base = get_backend(slot, base_name)
        if base is None:
            findings.append(Finding(
                "plan_audit", "PA103", plan_path, plan_line, slot,
                f"slot has no {base_name!r} baseline backend registered"))
            continue
        for name, spec in sorted(named.items()):
            spath, sline = _anchor(spec.impl)
            for mcfg in models:
                for ecfg in execs:
                    pred_calls += 1
                    try:
                        reason = spec.supported(mcfg, ecfg)
                    except Exception as e:  # noqa: BLE001
                        findings.append(Finding(
                            "plan_audit", "PA102", spath, sline,
                            f"{slot}:{name}",
                            f"capability predicate raised "
                            f"{type(e).__name__}: {e} for "
                            f"{_describe(mcfg, ecfg)}"))
                        break
                    if name == base_name and reason is not None:
                        findings.append(Finding(
                            "plan_audit", "PA103", spath, sline,
                            f"{slot}:{name}",
                            f"baseline backend rejects "
                            f"{_describe(mcfg, ecfg)}: {reason} — the "
                            f"slot chain cannot terminate"))
                        break
                else:
                    continue
                break

    # --- PA104: every registered backend reachable -----------------------
    unreachable = []
    for slot, named in sorted(backends.items()):
        for name, spec in sorted(named.items()):
            reached = False
            for mcfg in models:
                for ecfg in execs:
                    try:
                        pinned = dataclasses.replace(
                            ecfg, op_overrides=((slot, name),))
                        if resolve_plan(mcfg, pinned).backend(slot) == name:
                            reached = True
                            break
                    except Exception:  # noqa: BLE001 — PA101 covers raises
                        continue
                if reached:
                    break
            if not reached:
                spath, sline = _anchor(spec.impl)
                findings.append(Finding(
                    "plan_audit", "PA104", spath, sline, f"{slot}:{name}",
                    "backend is unreachable: no matrix config, even with "
                    "an explicit op_overrides pin, resolves to it"))
                unreachable.append(f"{slot}:{name}")

    # --- PA105: names advertised in docs/bench gates exist ---------------
    findings += _audit_doc_names(backends)

    # --- PA106: override order must not split the cache key --------------
    from ..configs.base import ExecConfig
    a = ExecConfig(op_overrides=(("lm_head", "raceit_q8"),
                                 ("softmax", "digital")))
    b = ExecConfig(op_overrides=(("softmax", "digital"),
                                 ("lm_head", "raceit_q8")))
    if a != b or hash(a) != hash(b):
        from ..configs import base as base_mod
        findings.append(Finding(
            "plan_audit", "PA106", _anchor(base_mod.ExecConfig)[0],
            _anchor(base_mod.ExecConfig)[1], "ExecConfig.op_overrides",
            "the same overrides in a different order produce unequal "
            "configs — duplicate resolve_plan cache entries"))

    stats = dict(
        models=len(models), exec_configs=len(execs), plans_resolved=plans,
        predicate_calls=pred_calls,
        backends=sum(len(v) for v in backends.values()),
        unreachable=unreachable,
    )
    return findings, stats


_NAME_RE = re.compile(r"\braceit_[a-z0-9_]+\b")
# README's section on the port (its heading holds this)
_PORT_SECTION = "src/repro_torch/"


def _audit_doc_names(backends, readme=None) -> list[Finding]:
    from ..core import attention as core_attn_mod
    from ..exec import noisy as noisy_mod
    from ..kernels import ops as ops_mod

    known = {n for named in backends.values() for n in named}
    for mod in (ops_mod, core_attn_mod, noisy_mod):
        known |= {n for n in dir(mod) if not n.startswith("_")}
    # launcher/example script stems (docs reference them by filename)
    for d in (REPO_ROOT / "examples",
              REPO_ROOT / "src" / "repro_torch" / "launch"):
        if d.exists():
            known |= {p.stem for p in d.glob("*.py")}

    findings: list[Finding] = []
    path = pathlib.Path(readme) if readme else REPO_ROOT / "README.md"
    if not path.exists():
        return findings
    try:
        rel = str(path.resolve().relative_to(REPO_ROOT))
    except ValueError:
        rel = str(path)
    inside = False
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        if line.startswith("## "):
            inside = _PORT_SECTION in line
        if not inside:
            continue
        for tok in _NAME_RE.findall(line):
            if tok in known:
                continue
            if tok.endswith("_") and any(n.startswith(tok) for n in known):
                continue   # family glob like raceit_noisy_*
            findings.append(Finding(
                "plan_audit", "PA105", rel, lineno, tok,
                f"references backend-style name `{tok}` that is not in the "
                f"port's registry or public kernel API"))
    return findings
