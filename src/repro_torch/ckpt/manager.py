"""Fault-tolerant checkpointing: atomic, asynchronous, restorable anywhere.

The port of `repro.ckpt.manager`, in its file format:

* ``<dir>/step-<n>/leaves.npz`` holds one array per leaf, named by the
  leaf's "/"-joined dict keys and list indices (``_root`` for a bare
  leaf); ``meta.json`` holds ``step``, ``paths``, each leaf's ``dtypes``
  name, the caller's ``extra`` and ``treedef``, a description of the
  tree's structure (`repro_torch.tree.structure`; the reference writes its
  own and neither side reads it). bfloat16 leaves are stored as uint16
  views and float8 as uint8, as numpy has neither dtype;
* atomic: a save is written to ``<dir>/tmp-<n>`` and published with
  `os.replace`, so a save cut short never replaces the latest checkpoint;
* asynchronous: ``save(..., block=False)`` copies every leaf to host
  memory before it returns, then writes on a background thread; one save
  is in flight at a time, and a failed write raises on the next `save` or
  `wait`;
* retention: the last ``keep`` checkpoints stay;
* restore into a template's structure, each leaf on the template leaf's
  device, on one ``device``, or on a tree of devices shaped like the
  template (a job restarted on another placement);
* placed trees (`repro_torch.dist.place_params`): a save writes each leaf
  whole, so the format does not change; a restore re-places each leaf as
  the template's placed leaf is placed: the reference's elastic restore,
  a run saved on one mesh resumed on another.

Either package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .. import tree
from ..dist.sharding import Placed

__all__ = ["CheckpointManager"]

# numpy has no bfloat16 or float8: such leaves are stored as integer views
_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
          torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
          torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_FROM_VIEW = {name: (dt, tv) for dt, (name, tv, _) in _VIEWS.items()}


def _path_name(path: tuple) -> str:
    return "/".join(str(k) for k in path) or "_root"


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of ``leaf`` that later writes to it do not reach, its
    dtype name)."""
    if isinstance(leaf, Placed):  # whole where it is, one copy to host
        leaf = leaf.gather(leaf.devices[0])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _VIEWS:
            name, tview, npview = _VIEWS[t.dtype]
            return t.view(tview).numpy().view(npview), name
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.array(leaf, copy=True)
    return arr, arr.dtype.name


def _from_saved(arr: np.ndarray, saved: Optional[str]) -> torch.Tensor:
    if saved in _FROM_VIEW:
        dtype, tview = _FROM_VIEW[saved]
        arr = arr.view(np.int16 if tview is torch.int16 else np.uint8)
        return torch.from_numpy(arr).view(dtype)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree_: Any, extra: Optional[dict] = None,
             block: bool = True):
        """Write ``tree_`` as step ``step``; ``extra`` is JSON. With
        ``block=False`` the leaves are on the host when this returns and
        the write goes on in a background thread."""
        self.wait()  # one in-flight save at a time
        leaves, dtypes = {}, {}
        for path, leaf in tree.leaves_with_paths(tree_):
            name = _path_name(path)
            leaves[name], dtypes[name] = _host_copy(leaf)
        meta = {"step": int(step), "treedef": tree.structure(tree_),
                "paths": list(leaves), "dtypes": dtypes,
                "extra": extra or {}}

        def _write():
            try:
                tmp = self.dir / f"tmp-{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "leaves.npz", **leaves)
                (tmp / "meta.json").write_text(json.dumps(meta))
                final = self.dir / f"step-{step}"
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)  # atomic publish
                self._gc()
            except BaseException as e:  # noqa: BLE001 (re-raised by wait)
                self._error = e

        if block:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the save in flight; raise if a save failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"checkpoint save failed: {e}") from e

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("-")[1])
                      for p in self.dir.glob("step-*"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None,
                device: Any = None) -> tuple[Any, dict]:
        """(the tree of step ``step`` (default: the latest) in
        ``template``'s structure and leaf dtypes, ``extra``).

        ``device``: None puts each leaf where the template's leaf is (the
        CPU for a leaf that is no tensor); one device puts every leaf
        there; a tree of devices shaped like the template places leaf by
        leaf. A placed template leaf is placed as it is, onto its mesh.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step-{step}"
        meta = json.loads((d / "meta.json").read_text())
        dtypes = meta.get("dtypes", {})
        flat = tree.leaves_with_paths(template)
        if device is None:
            devices = [leaf.device if isinstance(leaf, torch.Tensor)
                       else torch.device("cpu") for _, leaf in flat]
        elif isinstance(device, (str, torch.device)):
            devices = [torch.device(device)] * len(flat)
        else:
            devices = [torch.device(x) for x in tree.leaves(device)]
            if len(devices) != len(flat):
                raise ValueError(f"{len(devices)} devices for a template of "
                                 f"{len(flat)} leaves")
        out = []
        with np.load(d / "leaves.npz") as z:
            for (path, tmpl), dev in zip(flat, devices):
                name = _path_name(path)
                t = _from_saved(z[name], dtypes.get(name))
                if isinstance(tmpl, (torch.Tensor, Placed)) \
                        and t.dtype != tmpl.dtype:
                    t = t.to(tmpl.dtype)
                out.append(tmpl.like(t) if isinstance(tmpl, Placed)
                           else t.to(dev))
        return tree.unflatten(template, out), meta["extra"]
