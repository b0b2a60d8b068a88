"""Carry the reference's parameters across, without JAX.

Two ways in, one layout out (the port's: ``{"embed", "final_norm",
"blocks": [one dict per layer]}`` of tensors, or for an encoder-decoder
``{"embed", "final_norm", "encoder": [...], "enc_norm", "decoder":
[...]}``):

* `params_from_numpy` takes the reference parameter tree as nested dicts and
  lists of numpy arrays (``jax.tree.map(np.asarray, params)``);
* `load_reference_checkpoint` reads a `repro.ckpt.CheckpointManager`
  directory: ``step-<n>/leaves.npz`` keyed by "/"-joined tree paths plus
  ``meta.json`` with each leaf's dtype (bfloat16 leaves are stored as uint16
  views).

The optimizer state crosses the same way (`opt_state_from_numpy`,
`load_reference_training_checkpoint`): the reference's AdamW moments ``mu``
and ``nu`` are scan-stacked exactly like its parameters, and ``step`` is a
scalar, so a run that the reference's `run_training` started resumes in the
port's `repro_torch.train.run_training`.

The reference stacks each period position's layers along a leading scan
dimension (``blocks/scan/<j>`` holds layers ``r*P + j``) and keeps the
``n_layers % P`` remainder in ``blocks/tail`` (an encoder-decoder's
``encoder`` and ``decoder`` stacks likewise, the encoder's of
``n_encoder_layers`` layers of one period); both are unstacked into
per-layer dicts in layer order; the empty parameter dicts of a
non-parametric LayerNorm, which a checkpoint does not store, come back
empty. Float weights come across as they are;
`repro_torch.models.quantize_model_params` then makes resident codes
bit-identical to the reference's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..models.model import encoder_config

__all__ = ["params_from_numpy", "opt_state_from_numpy",
           "load_reference_checkpoint", "load_reference_training_checkpoint"]


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


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's (scan-stacked) parameter tree -> the port's layout,
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    out = {"embed": _tree(tree["embed"], device),
           "final_norm": _tree(tree.get("final_norm", {}), device)}
    if cfg.is_encoder_decoder:
        out["encoder"] = _layers(tree["encoder"], encoder_config(cfg),
                                 cfg.n_encoder_layers, device)
        out["enc_norm"] = _tree(tree.get("enc_norm", {}), device)
        out["decoder"] = _layers(tree["decoder"], cfg, cfg.n_layers, device,
                                 cross=True)
    else:
        out["blocks"] = _layers(tree["blocks"], cfg, cfg.n_layers, device)
    return out


def opt_state_from_numpy(state: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's AdamW state ``{"mu", "nu", "step"}`` -> the port's:
    the moments in the port's parameter layout, ``step`` an int32 scalar."""
    device = resolve_device(device)
    return {"mu": params_from_numpy(state["mu"], cfg, device),
            "nu": params_from_numpy(state["nu"], cfg, device),
            "step": _tensor(state["step"], device).to(torch.int32)}


def _layers(stack: dict, cfg: ModelConfig, n_layers: int, device,
            cross: bool = False) -> list:
    """One reference stack (``scan`` + ``tail``) -> per-layer dicts."""
    P = cfg.block_period
    n_full = n_layers // P
    # an empty list leaves no paths in a checkpoint, so either may be absent
    scan = stack.get("scan", [])
    tail = stack.get("tail", [])
    layers = []
    for t in range(n_layers):
        if t < n_full * P:
            r, j = divmod(t, P)
            layers.append(_unstack(scan[j], r, device))
        else:
            layers.append(_tree(tail[t - n_full * P], device))
        # a non-parametric LayerNorm is an empty dict, which leaves no path;
        # a layer with no FFN has no norm2
        norms = ("norm1",) if cfg.layer_spec(t)[1] == "none" else (
            "norm1", "norm2")
        for norm in norms + (("norm_x",) if cross else ()):
            layers[-1].setdefault(norm, {})
    return layers


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


def _read(directory, step: Optional[int]) -> tuple:
    """(the saved tree as nested dicts and lists of arrays, meta)."""
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
    return _nest(flat), meta


def load_reference_checkpoint(directory, cfg: ModelConfig,
                              step: Optional[int] = None,
                              device=None) -> dict:
    """Read a reference checkpoint of model parameters into the port's layout.

    The saved tree may be the parameters themselves or a tuple whose first
    element they are (the launchers save ``(params, opt_state)``). Tensors
    land on ``device``: ``cuda`` unless the caller asks for the CPU.
    """
    device = resolve_device(device)
    tree, _ = _read(directory, step)
    if isinstance(tree, list):
        tree = tree[0]
    return params_from_numpy(tree, cfg, device)


def load_reference_training_checkpoint(directory, cfg: ModelConfig,
                                       step: Optional[int] = None,
                                       device=None) -> tuple:
    """Read the ``(params, opt_state)`` checkpoint of the reference's
    `run_training` (paths ``0/...``, ``1/mu/...``, ``1/nu/...``,
    ``1/step``) -> the port's ``(params, opt_state, extra)``; ``extra``
    holds ``step`` and ``data_state``. Saved with a
    `repro_torch.ckpt.CheckpointManager` into a run's directory, the state
    resumes in `repro_torch.train.run_training`."""
    device = resolve_device(device)
    (params, state), meta = _read(directory, step)
    return (params_from_numpy(params, cfg, device),
            opt_state_from_numpy(state, cfg, device), meta["extra"])
