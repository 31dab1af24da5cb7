"""Shared helpers of the PyTorch-port tests (``test_torch_*.py``).

The port is held against the JAX package on the CPU: the same numpy
inputs go through both, and JAX parameter trees cross over as numpy.
"""

import dataclasses

import jax
import numpy as np
import torch

import repro.collectives.engine as jax_engine
import repro.configs as jax_configs
import repro_torch.collectives.engine as torch_engine
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


def record_engines(monkeypatch):
    """Every ``CollectiveEngine`` of either package made while the test
    runs, in a list.  A test that persists decisions flushes them at its
    end, while its private cache directories are still set: an engine
    left dirty would write at interpreter exit, into the default cache
    directory, and a calibrated topology there leaks into every later
    ``get_engine()`` of the process."""
    made = []
    for cls in (torch_engine.CollectiveEngine, jax_engine.CollectiveEngine):
        def init(self, *args, _init=cls.__init__, **kwargs):
            _init(self, *args, **kwargs)
            made.append(self)
        monkeypatch.setattr(cls, "__init__", init)
    return made
