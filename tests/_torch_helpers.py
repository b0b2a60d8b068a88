"""Shared helpers of the port's parity tests (JAX reference vs repro_torch).

Data crosses between the two packages as numpy arrays only.

Every port test file imports this module, which sets torch to one
intra-op thread in the process: the tests run small tensors, and under
pytest-xdist several worker processes share the cores, so torch's
default of a thread per core in each worker oversubscribes the CPU (the
port's tests took 1040 s under ``-n 6`` with the default and 477 s with
one thread a worker, on an 8-core machine). No result depends on it: the
port's tests pass either way.
"""
import dataclasses

import jax
import numpy as np
import torch

torch.set_num_threads(1)

import repro_torch.configs.base as port_base
from repro_torch.ckpt import params_from_numpy


def port_model_config(cfg):
    """The port's ModelConfig with every field of the reference's."""
    return port_base.ModelConfig(**dataclasses.asdict(cfg))


def port_noise_config(nz):
    """The port's NoiseConfig with every field of the reference's."""
    if nz is None:
        return None
    from repro_torch.hw.noise import NoiseConfig
    return NoiseConfig(**dataclasses.asdict(nz))


def port_mesh_spec(mesh):
    """The port's MeshSpec with the reference's axes."""
    if mesh is None:
        return None
    from repro_torch.dist import MeshSpec
    return MeshSpec(axes=tuple(mesh.axes))


def port_exec_config(ec):
    """The port's ExecConfig with the reference's declarative fields."""
    return port_base.ExecConfig(
        mode=ec.mode, softmax_mode=ec.softmax_mode,
        matmul_fidelity=ec.matmul_fidelity, act_bits=ec.act_bits,
        weight_bits=ec.weight_bits, fused_attention=ec.fused_attention,
        op_overrides=ec.op_overrides, noise=port_noise_config(ec.noise),
        mesh=port_mesh_spec(ec.mesh))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def port_params(jax_params, cfg):
    """The reference's float parameter tree in the port's layout (CPU)."""
    return params_from_numpy(to_numpy(jax_params), port_model_config(cfg),
                             device="cpu")
