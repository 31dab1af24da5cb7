"""The dense decoder's block sharded over "model" (``sharding.rules.
shard_params``), on model-rank threads of the CPU, against the JAX
package's single-device results from the same weights and inputs
(reduced float32 configs, ``tp_util``): ``forward_train`` logits and
loss within 1e-5, the gradients gathered by ``unshard_params`` within
1e-4 of ``jax.grad``, prefill + greedy decode (identical tokens, logits
within 1e-5), the paged chunk and decode step, at m 2 and 4, with vision
soft tokens (``llava-next-34b``) and an odd vocabulary (padded to the
model axis, ``test_torch_vocab_padding.py``).

Then the train step: a (data 2, model 2) grid of rank threads against
the reference's one-device step over 2 steps in both sync modes, the
leaves whole on every rank bitwise equal across the model axis; and the
one-process-a-rank route the cards use, under ``torch.distributed.run``
over gloo, bitwise equal to the threads.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.collectives import run_local_grid
from repro_torch.models.layers import ambient_grid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.rules import (model_sharded_leaves, shard_params,
                                        unshard_params)
from repro_torch.train.state import init_train_state
from repro_torch.train.step import GradSyncConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from tp_util import (Model, check_forward, check_grads, check_greedy,
                     check_paged)

ROOT = Path(__file__).resolve().parents[1]

CASES = [("minicpm-2b", 2, {}), ("minicpm-2b", 4, {}), ("yi-34b", 2, {}),
         ("llava-next-34b", 2, {}), ("minicpm-2b", 2, {"vocab_size": 257})]
IDS = [f"{a}-m{m}" + ("-odd_vocab" if kw else "") for a, m, kw in CASES]

_MODELS = {}


def _model(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        _MODELS[key] = Model(arch, **kw)
    return _MODELS[key]


@pytest.mark.parametrize("arch,m,kw", CASES, ids=IDS)
def test_forward_and_loss_match_reference(arch, m, kw):
    check_forward(_model(arch, **kw), m)


@pytest.mark.parametrize("arch,m,kw", CASES, ids=IDS)
def test_gradients_match_jax_grad(arch, m, kw):
    check_grads(_model(arch, **kw), m)


@pytest.mark.parametrize("arch,m,kw", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_reference(arch, m, kw):
    check_greedy(_model(arch, **kw), m)


@pytest.mark.parametrize("arch,m", [("minicpm-2b", 2), ("yi-34b", 2),
                                    ("minicpm-2b", 4)])
def test_paged_chunk_and_decode_match_reference(arch, m):
    check_paged(_model(arch), m)


def test_fused_down_projection_takes_a_rank_local_w_down(monkeypatch):
    """Under ``set_fused_tp`` a rank's tree runs its SwiGLU's reduction as
    the fused ring on its own ``w_down`` block (the ring's price made to
    favour it), as it stands: logits and gradients as the reference's."""
    from repro_torch.collectives import CollectiveEngine, shardmap_impl
    from repro_torch.models import layers
    price = CollectiveEngine.price_fused_matmul_rs
    monkeypatch.setattr(CollectiveEngine, "price_fused_matmul_rs",
                        lambda self, *a, **k: dict(price(self, *a, **k),
                                                   saved=1.0))
    calls = []
    ring = shardmap_impl.fused_matmul_rs
    monkeypatch.setattr(shardmap_impl, "fused_matmul_rs",
                        lambda x, w, comm, *a, **k:
                        calls.append(tuple(w.shape))
                        or ring(x, w, comm, *a, **k))
    layers.set_fused_tp(True)
    try:
        model = _model("minicpm-2b")
        check_forward(model, 2)
        check_grads(model, 2)
    finally:
        layers.set_fused_tp(False)
    d, f = model.cfg.d_model, model.cfg.d_ff
    # the ring ran on each rank's own [F / 2, D] block of w_down
    assert calls and set(calls) == {(f // 2, d)}


# ------------------------- the train step ------------------------------ #
OPT = dict(warmup_steps=1, total_steps=10)
STEPS = 2
TOL = dict(params=(1e-4, 1e-5), loss=(1e-5, 1e-6), gnorm=(1e-4, 1e-6))
TRAIN_ARCH = "yi-34b"


def _reference_steps(model):
    step = jax.jit(j_make_step(model.jcfg, JAdamWConfig(**OPT)))
    st = j_init_state(model.jp)
    batch = model.jbatch()
    ms = []
    for _ in range(STEPS):
        st, m = step(st, batch)
        ms.append((float(m["loss"]), float(m["grad_norm"])))
    from torch_util import jax_params_numpy
    from repro_torch.convert import params_from_jax
    return params_from_jax(jax_params_numpy(st.params), model.cfg,
                           "cpu"), ms


def _rows(batch, rank, n):
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _tp_dp_run(model, mode):
    """Each rank of a (data 2, model 2) grid: its own copy of its shards,
    its data block of the rows, ``STEPS`` steps; (whole params, the
    rank's params, metrics)."""
    def fn(grid):
        local = tree_map(lambda t: t.clone(),
                         shard_params(model.params, model.cfg, grid))
        gs = GradSyncConfig(grid=grid, axes=("data",), mode=mode)
        step = make_train_step(model.cfg, AdamWConfig(**OPT), grad_sync=gs)
        st = init_train_state(local)
        ms = []
        with ambient_grid(grid):
            for _ in range(STEPS):
                st, m = step(st, _rows(model.tbatch(), grid.axis_index(
                    "data"), 2))
                ms.append((float(m["loss"]), float(m["grad_norm"])))
        whole = unshard_params(st.params, model.cfg, grid)
        return whole, st.params, ms

    return run_local_grid(fn, (2, 2), ("data", "model"), "cpu",
                          timeout=120)


@pytest.mark.parametrize("mode", ["allreduce", "fsdp"])
def test_data_model_grid_step_matches_reference(mode):
    model = _model(TRAIN_ARCH)
    want, want_ms = _reference_steps(model)
    out = _tp_dp_run(model, mode)
    sharded = model_sharded_leaves(out[0][1], model.cfg)
    assert any(sharded) and not all(sharded)
    for whole, _, ms in out:
        for a, b in zip(tree_leaves(whole), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=TOL["params"][0],
                                       atol=TOL["params"][1])
        for (loss, gnorm), (wl, wg) in zip(ms, want_ms):
            np.testing.assert_allclose(loss, wl, *TOL["loss"])
            np.testing.assert_allclose(gnorm, wg, *TOL["gnorm"])
    # grid rank 2 d + j is (data d, model j): the leaves whole on every
    # rank are bitwise equal across the model axis
    for d in range(2):
        a, b = tree_leaves(out[2 * d][1]), tree_leaves(out[2 * d + 1][1])
        for x, y, cut in zip(a, b, sharded):
            if not cut:
                assert torch.equal(x, y)
        assert out[2 * d][2] == out[2 * d + 1][2]


_TORCHRUN_SCRIPT = textwrap.dedent(r"""
    import os, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[1])
    import test_torch_tp_block_dense as t
    from repro_torch.collectives import ProcessGroupGrid
    from repro_torch.convert import params_from_jax
    from repro_torch.models.layers import ambient_grid
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import shard_params
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    grid = ProcessGroupGrid((2,), ("model",), device="cpu")
    data = np.load(sys.argv[2], allow_pickle=True)
    cfg = data["cfg"].item()
    whole = params_from_jax(data["params"].item(), cfg, "cpu")
    st = init_train_state(shard_params(whole, cfg, grid))
    step = make_train_step(cfg, AdamWConfig(**t.OPT))
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    res = {}
    with ambient_grid(grid):
        for i in range(t.STEPS):
            st, m = step(st, batch)
            res[f"loss{i}"] = np.asarray(float(m["loss"]))
    for j, leaf in enumerate(tree_leaves(st.params)):
        res[f"p{j}"] = leaf.numpy()
    np.savez(os.path.join(sys.argv[3], f"rank{rank}.npz"), **res)
    dist.destroy_process_group()
""")


def test_torchrun_gloo_processes_equal_the_rank_threads(tmp_path):
    model = _model(TRAIN_ARCH)
    np.savez(tmp_path / "in.npz", cfg=np.array(model.cfg, dtype=object),
             params=np.array(model.np_params, dtype=object),
             tokens=model.batch["tokens"], labels=model.batch["labels"])
    script = tmp_path / "tp_train.py"
    script.write_text(_TORCHRUN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(ROOT / "tests"),
         str(tmp_path / "in.npz"), str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]

    def fn(grid):
        st = init_train_state(tree_map(
            lambda t: t.clone(), shard_params(model.params, model.cfg,
                                              grid)))
        step = make_train_step(model.cfg, AdamWConfig(**OPT))
        losses = []
        with ambient_grid(grid):
            for _ in range(STEPS):
                st, m = step(st, model.tbatch())
                losses.append(float(m["loss"]))
        return st.params, losses

    threads = run_local_grid(fn, (2,), ("model",), "cpu", timeout=120)
    for r, (params, losses) in enumerate(threads):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        for i, loss in enumerate(losses):
            assert got[f"loss{i}"] == np.float32(loss)
        for j, leaf in enumerate(tree_leaves(params)):
            assert np.array_equal(got[f"p{j}"], leaf.numpy()), (r, j)
