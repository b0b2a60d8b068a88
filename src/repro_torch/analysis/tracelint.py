"""AST lint over src/repro_torch: host synchronisation on the hot path,
fallbacks in backends, plan-cache key hygiene.

The port of `repro.analysis.tracelint`. JAX's trace-safety rules (TL101,
a Python branch on a traced value; TL102, a tracer made concrete) become
one rule for eager PyTorch, where the same code is legal but stalls the
host until the card has caught up:

TL101 — a host synchronisation in code reached from `Model.decode_step`,
    `Model.prefill_chunk`, a registered backend or the serving loop around
    them (`ContinuousBatcher.step`): ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int()``/``float()``/
    ``bool()`` of a tensor, an ``if``/``while`` on a tensor, or
    ``torch.cuda.synchronize``. Reachability is a call graph over the
    port's functions, resolved by name (a call reaches every function of
    that name: an over-approximation). A value is a tensor when it comes
    from a ``torch.*`` call, a tensor method of another tensor, or a
    parameter annotated ``torch.Tensor``, and ``.any()``/``.all()`` of
    anything numpy did not build; ``.shape``/``.ndim``/``.dtype``
    and ``len()`` give host values, and ``is None`` tests are free. Every
    sync found is a finding: the justified ones are listed one by one in
    the suppression file, and removing them is work for a speed change.
TL103 — shape-dependent fallback branch inside a ``@register(...)``-ed
    backend implementation (warn), as the reference's.
TL104 — plan-cache key hygiene on the dataclasses in `resolve_plan`'s
    cache key, as the reference's.
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Optional

from .findings import REPO_ROOT, Finding

SRC = REPO_ROOT / "src" / "repro_torch"
SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize", "device",
               "is_cuda", "numel", "element_size", "dim"}
CONCRETIZERS = {"int", "float", "bool"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
HASHABLE_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "tuple"}
# where the decode path starts: (class or None, function); the batcher's
# step is the serving loop around decode_step and prefill_chunk
ROOTS = (("Model", "decode_step"), ("Model", "prefill_chunk"),
         ("ContinuousBatcher", "step"))


def _rel(path: pathlib.Path) -> str:
    try:
        return str(path.resolve().relative_to(REPO_ROOT))
    except ValueError:
        return str(path)


def _register_decorator(dec: ast.expr) -> bool:
    if isinstance(dec, ast.Call):
        fn = dec.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", "")
        return name == "register"
    return False


def _supported_predicates(tree: ast.AST) -> set:
    """Names passed as supported=/serving_supported= to @register calls."""
    preds: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _register_decorator(node):
            for kw in node.keywords:
                if kw.arg and "supported" in kw.arg and isinstance(
                        kw.value, ast.Name):
                    preds.add(kw.value.id)
    return preds


# ---------------------------------------------------------------------------
# the call graph, by name
# ---------------------------------------------------------------------------

def _functions(tree: ast.Module):
    """(class name or None, FunctionDef) of a module's functions and
    methods (nested defs belong to their enclosing function)."""
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            yield None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    yield node.name, sub


def _called_names(fn: ast.FunctionDef) -> tuple[set, set]:
    """(functions, methods) ``fn`` calls by name: ``f(...)``,
    ``mod.f(...)`` and bare names used as values (handed to a helper that
    calls them) name module-level functions; ``self.f(...)`` names a
    method of the same class."""
    funcs, methods = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                funcs.add(f.id)
            elif isinstance(f, ast.Attribute):
                if isinstance(f.value, ast.Name) and f.value.id in (
                        "self", "cls"):
                    methods.add(f.attr)
                else:
                    funcs.add(f.attr)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            funcs.add(node.id)
    return funcs, methods


# ---------------------------------------------------------------------------
# TL101: host synchronisation
# ---------------------------------------------------------------------------

class _Taint:
    """Names bound to tensors within one function."""

    def __init__(self, fn: ast.FunctionDef):
        self.tainted = set()
        for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
            if a.annotation is not None and "Tensor" in ast.unparse(
                    a.annotation):
                self.tainted.add(a.arg)
        # two sweeps reach names bound from names bound later in the text
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    value = node.value
                    if value is None or not self.tensor(value):
                        continue
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                self.tainted.add(n.id)

    def tensor(self, node: ast.expr) -> bool:
        """Does ``node`` evaluate to a tensor (as far as names tell)?"""
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_ATTRS:
                return False
            return self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                return False   # len(), int(), a helper: a host value
            if isinstance(f, ast.Attribute):
                if f.attr in SHAPE_ATTRS or f.attr in SYNC_METHODS:
                    return False
                if f.attr in ("any", "all") and not _numpy_receiver(f.value):
                    return True    # a reduction to a 0-d tensor
                root = f.value
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "torch":
                    return not _HOST_TORCH.match(ast.unparse(f))
                return self.tensor(f.value)
            return False
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.tensor(x) for x in [node.left] + node.comparators)
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp)):
            return any(self.tensor(c) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        return False


# torch functions that return host values, not tensors
_HOST_TORCH = re.compile(r"torch\.(cuda\.|is_|get_|device|finfo|iinfo|"
                         r"Generator|Size|dtype|promote_types|"
                         r"are_deterministic)")


def _numpy_receiver(node: ast.expr) -> bool:
    """A receiver built by numpy (``np.x(...)...``): not a tensor."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in ("np", "numpy"):
            return True
    return False


def lint_host_syncs(fn: ast.FunctionDef, rel: str,
                    site: Optional[str] = None) -> list[Finding]:
    """TL101 findings of one function (its nested defs included)."""
    taint = _Taint(fn)
    site = site or fn.name
    out: list[Finding] = []

    def add(node, what):
        out.append(Finding("tracelint", "TL101", rel, node.lineno, site,
                           f"host sync: {what}"))

    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if taint.tensor(node.test):
                kind = {"If": "if", "While": "while", "IfExp": "if"}[
                    type(node).__name__]
                add(node, f"`{kind}` on a tensor ({ast.unparse(node.test)})")
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in CONCRETIZERS:
                if node.args and taint.tensor(node.args[0]):
                    add(node, f"`{f.id}()` of a tensor "
                              f"({ast.unparse(node.args[0])})")
            elif isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                # numpy arrays have .tolist() too: only a tensor's counts
                if not _numpy_receiver(f.value) and (
                        f.attr != "tolist" or taint.tensor(f.value)):
                    add(node, f"`.{f.attr}()` ({ast.unparse(f.value)})")
            elif (isinstance(f, ast.Attribute) and f.attr == "synchronize"
                  and "cuda" in ast.unparse(f.value)):
                add(node, "`torch.cuda.synchronize()`")
    return out


# ---------------------------------------------------------------------------
# TL103: fallbacks inside registered backends
# ---------------------------------------------------------------------------

def _lint_backend_impl(fn: ast.FunctionDef, rel: str) -> list[Finding]:
    """TL103: shape-derived `if` fallbacks inside a registered backend."""
    findings: list[Finding] = []
    shape_attrs = {"shape", "ndim", "dtype", "size", "itemsize"}
    shape_names: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            if any(isinstance(n, ast.Attribute) and n.attr in shape_attrs
                   for n in ast.walk(node.value)):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            shape_names.add(n.id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        test_names = {n.id for n in ast.walk(node.test)
                      if isinstance(n, ast.Name)}
        direct = any(isinstance(n, ast.Attribute) and n.attr in shape_attrs
                     for n in ast.walk(node.test))
        if direct or (test_names & shape_names):
            findings.append(Finding(
                "tracelint", "TL103", rel, node.lineno, fn.name,
                f"shape-dependent fallback `{ast.unparse(node.test)}` "
                f"inside a registered backend impl — belongs in the "
                f"supported= capability predicate", severity="warn"))
    return findings


# ---------------------------------------------------------------------------
# TL104: plan-cache key dataclass hygiene
# ---------------------------------------------------------------------------

def _cache_key_classes(plan_path: pathlib.Path) -> set:
    """Annotation names of lru_cache'd resolve-function params in plan.py."""
    classes: set = set()
    try:
        tree = ast.parse(plan_path.read_text())
    except (OSError, SyntaxError):
        return classes
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        if not any("cache" in ast.unparse(d) for d in node.decorator_list):
            continue
        for a in node.args.args + node.args.kwonlyargs:
            if a.annotation is not None:
                ann = ast.unparse(a.annotation)
                classes.add(ann.split("[")[0].split(".")[-1])
    return classes


def _lint_cache_key_class(cls: ast.ClassDef, rel: str) -> list[Finding]:
    findings: list[Finding] = []
    post = next((n for n in cls.body if isinstance(n, ast.FunctionDef)
                 and n.name == "__post_init__"), None)
    post_src = ast.unparse(post) if post else ""
    field_names = {f.target.id for f in cls.body
                   if isinstance(f, ast.AnnAssign)
                   and isinstance(f.target, ast.Name)}
    sorted_fields: set = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg in field_names and "sorted(" in ast.unparse(kw.value):
                sorted_fields.add(kw.arg)
        if isinstance(node.func, ast.Name) and node.func.id == "sorted":
            src = ast.unparse(node)
            sorted_fields |= {n for n in field_names if n in src}

    for f in cls.body:
        if not (isinstance(f, ast.AnnAssign)
                and isinstance(f.target, ast.Name)):
            continue
        name = f.target.id
        ann = ast.unparse(f.annotation)
        base = ann.replace("Optional[", "").rstrip("]").split("[")[0]
        site = f"{cls.name}.{name}"
        if base in ("list", "List", "dict", "Dict", "set", "Set"):
            findings.append(Finding(
                "tracelint", "TL104", rel, f.lineno, site,
                f"unhashable annotation `{ann}` on a plan-cache key field"))
        elif base not in HASHABLE_ANNOTATIONS:
            if f"hash(self.{name})" not in post_src:
                findings.append(Finding(
                    "tracelint", "TL104", rel, f.lineno, site,
                    f"opaque annotation `{ann}` on a plan-cache key field "
                    f"without a fail-fast `hash(self.{name})` in "
                    f"__post_init__"))
        if name in sorted_fields:
            if "sorted" not in post_src or name not in post_src:
                findings.append(Finding(
                    "tracelint", "TL104", rel, f.lineno, site,
                    f"`{name}` is sorted by a `with_*` method (order is "
                    f"non-semantic) but __post_init__ does not "
                    f"canonicalize it — direct construction mints "
                    f"duplicate cache entries"))
    return findings


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _modules(root: pathlib.Path) -> list:
    """(rel path, module AST) of every module under ``root`` but the
    analysis and the launchers (host code by design)."""
    out = []
    for path in sorted(root.rglob("*.py")):
        if "analysis" in path.parts or "launch" in path.parts:
            continue
        try:
            out.append((_rel(path), ast.parse(path.read_text())))
        except (OSError, SyntaxError):
            continue
    return out


def reached_functions(modules: list, roots=ROOTS) -> list:
    """(rel, class, FunctionDef) of every function reachable from the
    decode-path roots and the registered backends, by name."""
    funcs: dict = {}     # name -> module-level functions
    methods: dict = {}   # (class, name) -> methods
    entries = []
    for rel, tree in modules:
        for cls, fn in _functions(tree):
            if cls is None:
                funcs.setdefault(fn.name, []).append((rel, cls, fn))
            else:
                methods.setdefault((cls, fn.name), []).append((rel, cls, fn))
            if (cls, fn.name) in roots or any(
                    _register_decorator(d) for d in fn.decorator_list):
                entries.append((rel, cls, fn))
    seen, order, stack = set(), [], list(entries)
    while stack:
        rel, cls, fn = stack.pop()
        key = (rel, cls, fn.name, fn.lineno)
        if key in seen:
            continue
        seen.add(key)
        order.append((rel, cls, fn))
        called, own = _called_names(fn)
        for name in called:
            stack.extend(funcs.get(name, ()))
        for name in own:
            stack.extend(methods.get((cls, name), ()))
    return sorted(order, key=lambda x: (x[0], x[2].lineno))


def run(root: Optional[pathlib.Path] = None) -> tuple[list[Finding], dict]:
    root = pathlib.Path(root) if root else SRC
    findings: list[Finding] = []
    modules = _modules(root)
    reached = reached_functions(modules)
    for rel, cls, fn in reached:
        site = f"{cls}.{fn.name}" if cls else fn.name
        findings += lint_host_syncs(fn, rel, site)
    backends = 0
    for rel, tree in modules:
        preds = _supported_predicates(tree)
        for _, fn in _functions(tree):
            if any(_register_decorator(d) for d in fn.decorator_list) \
                    and fn.name not in preds:
                backends += 1
                findings += _lint_backend_impl(fn, rel)

    plan_path = root / "exec" / "plan.py"
    key_classes = _cache_key_classes(plan_path) if plan_path.exists() else set()
    checked = []
    cfg_path = root / "configs" / "base.py"
    if key_classes and cfg_path.exists():
        tree = ast.parse(cfg_path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name in key_classes:
                checked.append(node.name)
                findings += _lint_cache_key_class(node, _rel(cfg_path))
    stats = dict(files=len(modules), reached_functions=len(reached),
                 backends=backends, cache_key_classes=sorted(checked))
    return findings, stats
