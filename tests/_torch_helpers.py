"""Shared helpers of the port's parity tests (JAX reference vs repro_torch).

Data crosses between the two packages as numpy arrays only.
"""
import dataclasses

import jax
import numpy as np

import repro_torch.configs.base as port_base
from repro_torch.ckpt import params_from_numpy


def port_model_config(cfg):
    """The port's ModelConfig with every field of the reference's."""
    return port_base.ModelConfig(**dataclasses.asdict(cfg))


def port_exec_config(ec):
    """The port's ExecConfig with the reference's declarative fields."""
    return port_base.ExecConfig(
        mode=ec.mode, softmax_mode=ec.softmax_mode,
        matmul_fidelity=ec.matmul_fidelity, act_bits=ec.act_bits,
        weight_bits=ec.weight_bits, fused_attention=ec.fused_attention,
        op_overrides=ec.op_overrides)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def port_params(jax_params, cfg):
    """The reference's float parameter tree in the port's layout (CPU)."""
    return params_from_numpy(to_numpy(jax_params), port_model_config(cfg),
                             device="cpu")
