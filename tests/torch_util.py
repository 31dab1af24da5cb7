"""Shared helpers of the PyTorch-port tests (``test_torch_*.py``).

The port is held against the JAX package on the CPU: the same numpy
inputs go through both, and JAX parameter trees cross over as numpy.
"""

import dataclasses

import jax
import numpy as np
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro_torch.convert import params_from_jax

CPU = torch.device("cpu")


def configs(arch, dtype="float32"):
    """(JAX config, port config) for the reduced ``arch``."""
    jcfg = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(torch_configs.get_config(arch).reduced(),
                               dtype=dtype)
    return jcfg, tcfg


def jax_params_numpy(params):
    return jax.tree.map(np.asarray, params)


def port_params(jax_params, tcfg):
    """The JAX parameter tree as the port's parameters on the CPU."""
    return params_from_jax(jax_params_numpy(jax_params), tcfg, CPU)
