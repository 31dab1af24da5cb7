"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's ``repro.sharding.rules``.

* Every parameter's spec, of every config the port initialises (full
  and reduced), equals the reference's ``PartitionSpec`` as a tuple on
  the (8,) ("data",), (2, 4) ("data", "model"), (2, 4) ("pod", "data")
  and (2, 2, 2) ("pod", "data", "model") meshes, with FSDP on and off.
  The reference rules its stacked ``[L, ...]`` leaves; a per-layer leaf
  of the port gets the stacked spec without its leading ``None``.
* ``grad_sync_axes_for_grid`` equals ``grad_sync_axes_for_mesh``; the
  batch, labels, cache and logits specs equal the reference's.
* ``train_state_shardings`` gives the moments the parameters' specs.
* ``local_shard``: the blocks of every rank tile the tensor.

The JAX side runs once per file in a subprocess with 8 virtual CPU
devices and hands its specs back as ``repr`` strings in an ``.npz``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import run_local_grid
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.sharding import rules
from repro_torch.train.state import (abstract_train_state,
                                     train_state_shardings)

ROOT = Path(__file__).resolve().parents[1]

ARCHS = ("minicpm-2b", "phi3-mini-3.8b", "mistral-nemo-12b", "yi-34b",
         "olmoe-1b-7b", "arctic-480b",
         "llava-next-34b", "falcon-mamba-7b")
MESHES = {"8": ((8,), ("data",)),
          "24": ((2, 4), ("data", "model")),
          "24dp": ((2, 4), ("pod", "data")),
          "222": ((2, 2, 2), ("pod", "data", "model"))}
#: (label, batch shapes) for the batch specs: divisible, a global batch
#: of 1 and one only a prefix of the DP axes divides
BATCHES = {"b8": (8, 16), "b1": (1, 16), "b2": (2, 16), "b6": (6, 16)}
#: (label, arch, cache entry shapes): dense caches with kv heads that
#: divide the model axis or not, lengths that divide or not; an SSM's
CACHES = {
    "minicpm_seq": {"k": (2, 8, 4104, 36, 64), "v": (2, 8, 4104, 36, 64),
                    "pos": ()},
    "minicpm_odd": {"k": (2, 2, 4101, 36, 64), "v": (2, 2, 4101, 36, 64),
                    "pos": ()},
    "yi_heads": {"k": (2, 4, 64, 8, 128), "v": (2, 4, 64, 8, 128),
                 "pos": ()},
    "ssm": {"conv": (2, 8, 3, 8192), "h": (2, 8, 8192, 16), "pos": ()},
    "ssm_odd": {"conv": (2, 3, 3, 6), "h": (2, 3, 6, 16), "pos": ()},
}

_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax
    from repro.configs import get_config
    from repro.models import param_specs
    from repro.sharding import rules

    archs, meshes, batches, caches = eval(sys.argv[2])
    out = {}
    for name, (shape, names) in meshes.items():
        mesh = jax.make_mesh(shape, names)
        out[f"axes|{name}"] = repr(rules.grad_sync_axes_for_mesh(mesh))
        for fsdp in (True, False):
            policy = rules.for_mesh(mesh, fsdp=fsdp)
            for arch in archs:
                for red in (False, True):
                    cfg = get_config(arch)
                    cfg = cfg.reduced() if red else cfg
                    leaves = jax.tree_util.tree_flatten_with_path(
                        param_specs(cfg))[0]
                    for path, leaf in leaves:
                        spec = rules.spec_for_param(path, leaf.shape, policy)
                        key = jax.tree_util.keystr(path)
                        out[f"param|{name}|{fsdp}|{arch}|{red}|{key}"] = (
                            repr(tuple(spec)))
            for label, shp in batches.items():
                sd = {"tokens": jax.ShapeDtypeStruct(shp, np.int32)}
                spec = rules.batch_sharding_specs(policy, sd)["tokens"]
                out[f"batch|{name}|{fsdp}|{label}"] = repr(tuple(spec))
            for label, entries in caches.items():
                sd = {k: jax.ShapeDtypeStruct(v, np.float32)
                      for k, v in entries.items()}
                specs = rules.cache_specs(None, policy, sd)
                for k, spec in specs.items():
                    out[f"cache|{name}|{fsdp}|{label}|{k}"] = repr(
                        tuple(spec))
            out[f"labels|{name}|{fsdp}"] = repr(tuple(
                rules.labels_spec(policy)))
            out[f"logits|{name}|{fsdp}"] = repr(tuple(
                rules.logits_spec(policy)))
    np.savez(sys.argv[1], **{k: np.array(v) for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_sharding")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "specs.npz"),
         repr((ARCHS, MESHES, BATCHES, CACHES))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {k: eval(str(v)) for k, v in np.load(tmp / "specs.npz").items()}


def _policy(mesh, fsdp):
    shape, names = MESHES[mesh]
    return rules.for_grid((names, shape), fsdp=fsdp)


def _meta_params(arch, red):
    cfg = get_config(arch)
    return init_params(cfg.reduced() if red else cfg, device="meta")


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(ref, arch, mesh, fsdp, red):
    params = _meta_params(arch, red)
    specs = rules.param_sharding_tree(params, None, _policy(mesh, fsdp))
    prefix = f"param|{mesh}|{fsdp}|{arch}|{red}|"
    want = {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}
    seen = set()
    for name, spec in specs.items():
        if name == "layers":
            def walk(specs_, params_, key):
                # nested dicts (Arctic's dense_mlp) nest in the key too
                for leaf, got in specs_.items():
                    k = f"{key}['{leaf}']"
                    if isinstance(got, dict):
                        walk(got, params_[leaf], k)
                        continue
                    full = want[k]
                    n_lead = len(full) - params_[leaf].dim()
                    assert n_lead <= 1 and all(
                        a is None for a in full[:n_lead]), (k, full)
                    assert got == full[n_lead:], (k, got, full)
                    seen.add(k)

            for i, layer in enumerate(spec):
                walk(layer, params["layers"][i], "['layers']")
        else:
            key = f"['{name}']"
            assert spec == want[key], (key, spec, want[key])
            seen.add(key)
    assert seen == set(want), set(want) ^ seen


@pytest.mark.parametrize("mesh", list(MESHES))
def test_grad_sync_axes_equal_the_reference(ref, mesh):
    shape, names = MESHES[mesh]
    assert rules.grad_sync_axes_for_grid((names, shape)) == \
        ref[f"axes|{mesh}"]


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "no_fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_cache_logits_specs_equal_the_reference(ref, mesh, fsdp):
    policy = _policy(mesh, fsdp)
    for label, shp in BATCHES.items():
        got = rules.batch_sharding_specs(
            policy, {"tokens": torch.empty(shp, device="meta")})["tokens"]
        assert got == ref[f"batch|{mesh}|{fsdp}|{label}"], (label, got)
    for label, entries in CACHES.items():
        shapes = {k: torch.empty(v, device="meta")
                  for k, v in entries.items()}
        for k, got in rules.cache_specs(None, policy, shapes).items():
            assert got == ref[f"cache|{mesh}|{fsdp}|{label}|{k}"], \
                (label, k, got)
    assert rules.labels_spec(policy) == ref[f"labels|{mesh}|{fsdp}"]
    assert rules.logits_spec(policy) == ref[f"logits|{mesh}|{fsdp}"]


def test_train_state_shardings_give_the_moments_the_param_specs():
    state = abstract_train_state(get_config("minicpm-2b"),
                                 master_weights=True)
    assert state.params["embed"].device.type == "meta"
    grid = (("data", "model"), (2, 4))
    sh = train_state_shardings(state, grid)
    want = rules.param_sharding_tree(state.params, grid)
    assert sh.params == want and sh.opt.mu == want and sh.opt.nu == want
    assert sh.opt.master == want and sh.opt.count == ()
    plain = train_state_shardings(
        abstract_train_state(get_config("minicpm-2b")), grid)
    assert plain.opt.master is None


@pytest.mark.parametrize("spec", [(("pod", "data"), None),
                                  ("data", "model"), (None, ("model",
                                                             "pod")),
                                  ()])
def test_local_shards_tile_the_tensor(spec):
    x = torch.arange(16 * 12, dtype=torch.float32).reshape(16, 12)

    def fn(g):
        return g.coords, rules.local_shard(x, spec, g).clone()

    got = run_local_grid(fn, (2, 2, 2), ("pod", "data", "model"), "cpu",
                         timeout=60)
    seen = torch.zeros_like(x)
    for coords, block in got:
        idx = []
        for dim, axes in enumerate(list(spec) + [None] * (2 - len(spec))):
            axes = () if axes is None else (
                (axes,) if isinstance(axes, str) else axes)
            n, i = 1, 0
            for a in axes:
                size = 2
                i = i * size + coords[("pod", "data", "model").index(a)]
                n *= size
            step = x.shape[dim] // n
            idx.append(slice(i * step, (i + 1) * step))
        assert torch.equal(block, x[tuple(idx)])
        seen[tuple(idx)] += 1
    # each element is held by the ranks the spec does not split over
    used = {a for axes in spec if axes is not None
            for a in ((axes,) if isinstance(axes, str) else axes)}
    assert torch.all(seen == 2 ** (3 - len(used)))


def test_local_shard_refuses_what_does_not_split():
    x = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="does not split"):
        run_local_grid(lambda g: rules.local_shard(x, ("data",), g),
                       (4,), ("data",), "cpu", timeout=60)


def test_axes_index_is_the_rank_in_the_sub_comm():
    subsets = [("pod",), ("model", "pod"), ("pod", "data", "model"),
               ("data", "pod")]

    def fn(g):
        return [(g.axes_index(a), g.sub(a).rank) for a in subsets]

    for pairs in run_local_grid(fn, (2, 2, 2), ("pod", "data", "model"),
                                "cpu", timeout=60):
        assert all(a == b for a, b in pairs), pairs
