"""The reference's dry-run stand-ins on simulated meshes, for the port's
dry-run tests (not collected; run as a script by tests/test_torch_dryrun.py).

    python tests/_torch_dryrun_child.py OUT.json

It runs under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the
reference's own test meshes (tests/test_dist.py): (4, 2) as data x model
and (2, 2, 2) as pod x data x model. The parent pytest process pins JAX to
one CPU device, and the flag only takes effect before JAX initializes, so
this runs in a child process. For each case of `CASES` it calls the
reference's `repro.launch.inputs.input_specs` (``jax.eval_shape`` only,
nothing is compiled) and writes every leaf's path, global shape, dtype,
PartitionSpec and per-device shard shape. Prints CHILD_OK on success.
"""
import json
import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

import jax  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.configs.base import ExecConfig  # noqa: E402
from repro.dist.sharding import MeshContext  # noqa: E402
from repro.launch import inputs  # noqa: E402
from repro.models import Model  # noqa: E402

# (arch, shape, quantize); every case runs on both meshes
CASES = [
    ("olmo-1b", "train_4k", False), ("olmo-1b", "prefill_32k", False),
    ("olmo-1b", "decode_32k", False), ("olmo-1b", "train_4k", True),
    ("olmo-1b", "decode_32k", True),
    ("jamba-v0.1-52b", "decode_32k", False),
    ("jamba-v0.1-52b", "long_500k", True),
    ("gemma3-4b", "prefill_32k", True),
    ("whisper-tiny", "prefill_32k", False),
    ("whisper-tiny", "decode_32k", True),
    ("bert-base", "prefill_32k", False),
    ("mixtral-8x22b", "decode_32k", True),
    ("llama4-scout-17b-a16e", "train_4k", False),
    ("qwen2-vl-2b", "prefill_32k", False),
    ("mamba2-130m", "long_500k", False),
    ("command-r-35b", "decode_32k", True),
    ("gpt2-large", "decode_32k", True),
    ("starcoder2-15b", "train_4k", True),
]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _table(values, shard_tree=None):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(values)[0]:
        path = "/".join(_key(k) for k in kp)
        spec = tuple(leaf.sharding.spec) if leaf.sharding is not None else ()
        spec = [list(e) if isinstance(e, tuple) else e for e in spec]
        spec += [None] * (len(leaf.shape) - len(spec))
        out[path] = dict(shape=list(leaf.shape), dtype=str(leaf.dtype),
                         spec=spec,
                         shard_shape=list(leaf.sharding.shard_shape(
                             leaf.shape)))
    return out


def main(out_path):
    results = {}
    for mesh_name, (shape, axes) in MESHES.items():
        mesh = jax.make_mesh(shape, axes)
        for arch, shp, quantize in CASES:
            cfg = get_config(arch)
            spec_shape = SHAPES[shp]
            policy = inputs.make_policy(mesh, cfg, spec_shape)
            model = Model(cfg, ExecConfig(), MeshContext(mesh))
            spec = inputs.input_specs(cfg, spec_shape, policy, model,
                                      quantize=quantize)
            entry = {}
            for name in ("params", "opt_state", "batch", "cache", "token"):
                if name in spec:
                    entry[name] = _table(spec[name])
            entry["model_flops"] = inputs.model_flops(cfg, spec["params"],
                                                      spec_shape)
            results[f"{mesh_name}|{arch}|{shp}|{int(quantize)}"] = entry
    Path(out_path).write_text(json.dumps(results))
    print("CHILD_OK")


if __name__ == "__main__":
    main(sys.argv[1])
