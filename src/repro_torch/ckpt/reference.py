"""Carry the reference's parameters across, without JAX.

Two ways in, one layout out (the port's: ``{"embed", "final_norm",
"blocks": [one dict per layer]}`` of tensors):

* `params_from_numpy` takes the reference parameter tree as nested dicts and
  lists of numpy arrays (``jax.tree.map(np.asarray, params)``);
* `load_reference_checkpoint` reads a `repro.ckpt.CheckpointManager`
  directory: ``step-<n>/leaves.npz`` keyed by "/"-joined tree paths plus
  ``meta.json`` with each leaf's dtype (bfloat16 leaves are stored as uint16
  views).

The reference stacks each period position's layers along a leading scan
dimension (``blocks/scan/<j>`` holds layers ``r*P + j``) and keeps the
``n_layers % P`` remainder in ``blocks/tail``; both are unstacked into
per-layer dicts in layer order. Float weights come across as they are;
`repro_torch.models.quantize_model_params` then makes resident codes
bit-identical to the reference's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["params_from_numpy", "load_reference_checkpoint"]


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes array: reinterpret the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(t, device):
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device) for v in t]
    return _tensor(t, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's (scan-stacked) parameter tree -> the port's layout."""
    if cfg.is_encoder_decoder or "blocks" not in tree:
        raise NotImplementedError("only decoder-only stacks are ported")
    P = cfg.block_period
    n_full = cfg.n_layers // P
    # an empty list leaves no paths in a checkpoint, so either may be absent
    scan = tree["blocks"].get("scan", [])
    tail = tree["blocks"].get("tail", [])
    layers = []
    for t in range(cfg.n_layers):
        if t < n_full * P:
            r, j = divmod(t, P)
            layers.append(_unstack(scan[j], r, device))
        else:
            layers.append(_tree(tail[t - n_full * P], device))
    return {"embed": _tree(tree["embed"], device),
            "final_norm": _tree(tree["final_norm"], device),
            "blocks": layers}


def _unstack(t, r: int, device):
    if isinstance(t, dict):
        return {k: _unstack(v, r, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_unstack(v, r, device) for v in t]
    if isinstance(t, torch.Tensor):
        return t[r].clone().to(device)
    return _tensor(np.asarray(t)[r], device)


def _nest(flat: dict) -> object:
    """{"a/0/b": leaf} -> nested dicts; all-digit keys become lists."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out
    return fix(root)


def _step_dir(directory: Path, step: Optional[int]) -> Path:
    if (directory / "leaves.npz").exists():
        return directory
    steps = sorted(int(p.name.split("-")[1]) for p in directory.glob("step-*"))
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return directory / f"step-{steps[-1] if step is None else step}"


def load_reference_checkpoint(directory, cfg: ModelConfig,
                              step: Optional[int] = None,
                              device="cpu") -> dict:
    """Read a reference checkpoint of model parameters into the port's layout.

    The saved tree may be the parameters themselves or a tuple whose first
    element they are (the launchers save ``(params, opt_state)``).
    """
    d = _step_dir(Path(directory), step)
    meta = json.loads((d / "meta.json").read_text())
    dtypes = meta.get("dtypes", {})
    flat = {}
    with np.load(d / "leaves.npz") as z:
        for path in z.files:
            arr = z[path]
            if dtypes.get(path) == "bfloat16":  # stored as a uint16 view
                flat[path] = torch.from_numpy(arr.view(np.int16).copy()
                                              ).view(torch.bfloat16)
            else:
                flat[path] = arr
    tree = _nest(flat)
    if isinstance(tree, list):
        tree = tree[0]
    return params_from_numpy(tree, cfg, device)
