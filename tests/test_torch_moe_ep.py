"""The model-axis MoE (``moe_ffn_sharded``) and expert parallelism
through the engine's all-to-all (``moe_ffn_ep``) on 8 CPU rank threads
(``run_local_grid``), against the JAX package's on 8 virtual devices.

* Grids (2, 4) over ("data", "model") and over ("pod", "data"), as
  ``tests/test_moe_ep.py`` uses; each rank holds its rows over the
  grid's DP axes (replicated over "model").  ``algorithm`` in ("lax",
  "auto", "hierarchical", "flat"): every rank's output and aux equal the
  reference's ``moe_ffn_ep`` under ``shard_map`` at 1e-5, the output the
  port's one-device ``moe_ffn`` at 1e-4, and ``auto`` equals ``lax`` at
  1e-5; ``moe_ffn_sharded`` equals the reference's at 1e-5 on ("data",
  "model") and the one-device path on ("pod", "data"), where both fall
  back to it.
* Gradients through the exchanges (on the CPU each rank thread runs its
  own backward, ROADMAP C15): the engine's against the native
  exchange's at 1e-4, and every path's against the one-device
  ``moe_ffn`` under the port's data-parallel convention (each rank
  differentiates its own loss, the step averages over the DP axes) at
  1e-4: the weights' gradients averaged over the DP ranks equal those of
  the global objective, and every model rank holds the same.
* Each rank computes with E / n_ep experts; the loud fallback fires
  where the reference's does (no EP axis, or E not divisible by the EP
  ranks), printing the reference's message.

The JAX side runs once per file in a subprocess with 8 virtual CPU
devices and hands its results back as ``.npz``.
"""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import CollectiveEngine, run_local_grid
from repro_torch.models import moe, moe_ep
from repro_torch.models.layers import ambient_grid
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]

G, GS, D, E, F, K = 8, 16, 12, 8, 24, 2
GRIDS = {"data_model": ((2, 4), ("data", "model")),
         "pod_data": ((2, 4), ("pod", "data"))}
ALGOS = ("lax", "auto", "hierarchical", "flat")
#: the aux term's weight in the gradient tests' loss
AUX_C = 0.5

_JAX_SCRIPT = textwrap.dedent(r"""
    import functools, sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.models.moe import moe_ffn, moe_ffn_sharded
    from repro.models.moe_ep import moe_ffn_ep

    data = dict(np.load(sys.argv[1]))
    grids, algos, k = eval(sys.argv[3])
    args = [jnp.asarray(data[n]) for n in ("x", "router", "wg", "wu", "wd")]
    out = {}
    o, a = moe_ffn(*args, top_k=k)
    out["plain/out"], out["plain/aux"] = np.asarray(o), np.asarray(a)
    for name, (shape, names) in grids.items():
        mesh = jax.make_mesh(shape, names)
        for algo in algos:
            with mesh:
                o, a = jax.jit(functools.partial(
                    moe_ffn_ep, top_k=k, algorithm=algo))(*args)
            out[f"{name}/ep/{algo}/out"] = np.asarray(o)
            out[f"{name}/ep/{algo}/aux"] = np.asarray(a)
        if "model" not in names:
            continue    # its fallback's shard hints fail under JAX 0.9
        with mesh:
            o, a = jax.jit(functools.partial(moe_ffn_sharded, top_k=k))(
                *args)
        out[f"{name}/sharded/out"] = np.asarray(o)
        out[f"{name}/sharded/aux"] = np.asarray(a)
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(G, GS, D)).astype(np.float32),
            "router": (rng.normal(size=(D, E)) * 0.5).astype(np.float32),
            "wg": (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            "wu": (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            "wd": (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32),
            "ct": rng.normal(size=(G, GS, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def inputs():
    return {k: torch.from_numpy(v) for k, v in _inputs().items()}


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_moe_ep")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "results.npz"), repr((GRIDS, ALGOS, K))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "results.npz"))


@pytest.fixture(scope="module")
def engine():
    return CollectiveEngine(persist=False, device="cpu")


def _rows(grid) -> slice:
    """This rank's rows of the global batch: its block over the grid's
    DP axes."""
    dp = rules.for_grid(grid).data_axes
    per = G // math.prod(grid.axis_size(a) for a in dp)
    start = grid.axes_index(dp) * per
    return slice(start, start + per)


def _path(path, algo, engine):
    if path == "sharded":
        return lambda *a: moe.moe_ffn_sharded(*a, top_k=K)
    return lambda *a: moe_ep.moe_ffn_ep(*a, top_k=K, algorithm=algo,
                                        engine=engine)


def _run(inputs, grid_key, path, algo, engine, grads=False):
    """Every rank's (rows, out, aux[, grads of x, router, wg, wu, wd])."""
    shape, names = GRIDS[grid_key]
    fn = _path(path, algo, engine)

    def body(grid):
        rows = _rows(grid)
        leaves = [inputs["x"][rows]] + [inputs[n] for n in
                                        ("router", "wg", "wu", "wd")]
        if grads:
            leaves = [t.detach().clone().requires_grad_() for t in leaves]
        with ambient_grid(grid):
            out, aux = fn(*leaves)
        if not grads:
            return rows, out, aux, None
        loss = (out * inputs["ct"][rows]).sum() + AUX_C * aux
        return rows, out.detach(), aux.detach(), torch.autograd.grad(
            loss, leaves)

    return run_local_grid(body, shape, names, device="cpu")


def _assemble(results):
    out = torch.zeros(G, GS, D)
    for rows, o, _, _ in results:
        out[rows] = o
    return out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("grid_key", list(GRIDS))
def test_moe_ffn_ep_matches_the_reference_and_moe_ffn(inputs, jax_results,
                                                      engine, grid_key,
                                                      algo):
    res = _run(inputs, grid_key, "ep", algo, engine)
    want = jax_results[f"{grid_key}/ep/{algo}/out"]
    for rows, out, aux, _ in res:
        np.testing.assert_allclose(out.numpy(), want[rows], rtol=1e-5,
                                   atol=1e-5)
        assert float(aux) == pytest.approx(
            float(jax_results[f"{grid_key}/ep/{algo}/aux"]), abs=1e-5)
    plain, _ = moe.moe_ffn(*(inputs[n] for n in ("x", "router", "wg", "wu",
                                                 "wd")), top_k=K)
    np.testing.assert_allclose(_assemble(res).numpy(), plain.numpy(),
                               rtol=1e-4, atol=1e-4)
    if algo == "auto":
        lax = _assemble(_run(inputs, grid_key, "ep", "lax", engine))
        np.testing.assert_allclose(_assemble(res).numpy(), lax.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid_key", list(GRIDS))
def test_moe_ffn_sharded_matches_the_reference(inputs, jax_results,
                                               engine, grid_key):
    """On ("pod", "data") there is no model axis and both packages take
    the one-device ``moe_ffn`` (the reference's, under a mesh, trips on
    its own shard hints under JAX 0.9, ROADMAP C2: it is held to its
    plain ``moe_ffn`` instead); each port rank runs it on its rows."""
    res = _run(inputs, grid_key, "sharded", None, engine)
    key = f"{grid_key}/sharded/out"
    want = jax_results[key] if key in jax_results else \
        jax_results["plain/out"]
    for rows, out, aux, _ in res:
        np.testing.assert_allclose(out.numpy(), want[rows], rtol=1e-5,
                                   atol=1e-5)
    if grid_key == "data_model":
        # aux: the mean over the data ranks of each one's rows
        for _, _, aux, _ in res:
            assert float(aux) == pytest.approx(
                float(jax_results[f"{grid_key}/sharded/aux"]), abs=1e-5)
    np.testing.assert_allclose(want, jax_results["plain/out"], rtol=1e-4,
                               atol=1e-4)


def _expected_grads(inputs, grid_key, path):
    """Gradients of the global objective J = sum(out * ct) / n_dp +
    AUX_C * (the mean over the aux shards of each shard's aux) through
    the one-device ``moe_ffn``: (dJ/dx * n_dp, dJ/d(router, wg, wu,
    wd))."""
    n_dp = 2 if grid_key == "data_model" else 8
    n_shards = 2 if path == "sharded" else 8
    leaves = [inputs[n].detach().clone().requires_grad_()
              for n in ("x", "router", "wg", "wu", "wd")]
    out, _ = moe.moe_ffn(*leaves, top_k=K)
    per = G // n_shards
    aux = sum(moe.moe_ffn(leaves[0][i * per:(i + 1) * per], *leaves[1:],
                          top_k=K)[1] for i in range(n_shards)) / n_shards
    loss = (out * inputs["ct"]).sum() / n_dp + AUX_C * aux
    grads = torch.autograd.grad(loss, leaves)
    return [grads[0] * n_dp] + list(grads[1:])


@pytest.mark.parametrize("path,grid_key", [("ep", "pod_data"),
                                           ("ep", "data_model"),
                                           ("sharded", "data_model")])
def test_gradients_through_the_exchanges(inputs, engine, path, grid_key):
    """Per-rank gradients: the engine's exchange vs the native one, and
    the DP-averaged weight gradients (every model rank's the same) and
    each rank's x gradient vs the one-device objective."""
    runs = {algo: _run(inputs, grid_key, path, algo, engine, grads=True)
            for algo in (("auto", "lax") if path == "ep" else (None,))}
    want = _expected_grads(inputs, grid_key, path)
    shape, names = GRIDS[grid_key]
    n_dp = 2 if grid_key == "data_model" else 8
    for algo, res in runs.items():
        if algo == "auto":
            for (_, _, _, ga), (_, _, _, gl) in zip(res, runs["lax"]):
                for a, b in zip(ga, gl):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               rtol=1e-4, atol=1e-4)
        for rows, _, _, g in res:
            np.testing.assert_allclose(g[0].numpy(), want[0][rows].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg="x")
        if "model" in names:
            # every model rank of a data rank holds the same gradients
            for r in range(0, 8, 4):
                for other in range(r + 1, r + 4):
                    for a, b in zip(res[r][3][1:], res[other][3][1:]):
                        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                                   rtol=1e-6, atol=1e-6)
        per_dp = 8 // n_dp
        for i, name in enumerate(("router", "wg", "wu", "wd"), start=1):
            mean = sum(res[r][3][i] for r in range(0, 8, per_dp)) / n_dp
            np.testing.assert_allclose(mean.numpy(), want[i].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("grid_key", list(GRIDS))
def test_each_rank_holds_its_experts_only(inputs, grid_key):
    shape, names = GRIDS[grid_key]

    def body(grid):
        ep_axes = moe_ep._ep_axes_for(grid)
        n = math.prod(grid.axis_size(a) for a in ep_axes)
        spec = ep_axes if len(ep_axes) > 1 else ep_axes[0]
        ws = moe.expert_weights(grid, inputs["wg"], inputs["wu"],
                                inputs["wd"], spec)
        lo = grid.axes_index(ep_axes) * (E // n)
        return n, [w.shape[0] for w in ws], torch.equal(
            ws[0], inputs["wg"][lo:lo + E // n])

    for n, counts, same in run_local_grid(body, shape, names, device="cpu"):
        assert n == 4 if grid_key == "data_model" else n == 8
        assert counts == [E // n] * 3 and same


def test_fallback_fires_loudly_where_the_reference_does(inputs, engine,
                                                         capsys):
    args = [inputs[n] for n in ("x", "router", "wg", "wu", "wd")]
    plain, _ = moe.moe_ffn(*args, top_k=K)
    moe_ep._warned_fallback = False
    out, _ = moe_ep.moe_ffn_ep(*args, top_k=K, engine=engine)
    assert torch.equal(out, plain)
    msg = capsys.readouterr().out
    assert ("[moe_ep] WARNING: falling back to the replicated-token "
            "shard_map path (no all-to-all dispatch): no ambient mesh / no "
            "EP-capable axis") in msg
    # E = 6 experts do not split over the 8 EP ranks of (pod, data)
    e6 = [args[0], args[1][:, :6], args[2][:6], args[3][:6], args[4][:6]]
    moe_ep._warned_fallback = False

    def body(grid):
        with ambient_grid(grid):
            return moe_ep.moe_ffn_ep(e6[0][_rows(grid)], *e6[1:], top_k=K,
                                     engine=engine)[0]

    outs = run_local_grid(body, *GRIDS["pod_data"], device="cpu")
    want, _ = moe.moe_ffn(*e6, top_k=K)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), want.numpy())
    msg = capsys.readouterr().out
    assert ("E=6 over 8 EP ranks (('pod', 'data')) or G=8 over 8 token "
            "shards does not tile") in msg
    assert msg.count("[moe_ep] WARNING") == 1        # once a process


def _torchrun_losses(tmp_path, extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--reduced", "--dp", "--steps", "3", "--batch", "4",
         "--seq", "32", "--device", "cpu", *extra], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    per_rank = {}
    for line in proc.stdout.splitlines():
        if line.startswith("[train] rank "):
            rank, _, losses = line[len("[train] rank "):].partition(
                " losses ")
            per_rank[int(rank)] = [float(x) for x in losses.split()]
    assert sorted(per_rank) == [0, 1], proc.stdout
    return per_rank, proc.stdout


def test_train_cli_moe_ep_under_torchrun(tmp_path):
    """``--dp --moe-ep`` on 2 gloo processes: the EP exchange over the
    ("data",) axis with a backward in every step, no fallback, the loss
    equal on both ranks, and within the bf16 tolerance (5e-2) of the
    same DP run without EP (the same arithmetic in other GEMM shapes;
    the aux is the mean of the ranks' in both)."""
    ep, out = _torchrun_losses(tmp_path, ["--moe-ep"])
    assert "expert-parallel MoE dispatch: all_to_all[auto]" in out
    assert "[moe_ep] WARNING" not in out
    assert ep[0] == ep[1]
    plain, _ = _torchrun_losses(tmp_path, [])
    assert plain[0] == plain[1]
    np.testing.assert_allclose(ep[0], plain[0], rtol=5e-2)


def test_remat_recompute_takes_the_forward_route_off_the_grid_thread():
    """ROADMAP C24: a checkpointed layer's recompute runs wherever the
    autograd engine runs it (on CUDA its own device thread, where the
    caller's ambient grid is not bound).  It must take the forward's EP
    route all the same: a backward called outside the ``ambient_grid``
    block (as the CUDA device thread sees it) gives the gradients of a
    backward inside it."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward_train, init_params
    from repro_torch.tree import tree_leaves, tree_map
    import dataclasses

    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                              moe_ep=True, dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(4, 16)).astype(np.int64))

    def grads(grid, outside):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        rows = tokens[2 * grid.rank:2 * grid.rank + 2]
        with ambient_grid(grid):
            logits, aux = forward_train(p, cfg, {"tokens": rows},
                                        remat=True)
            loss = logits.float().square().mean() + AUX_C * aux
            if not outside:
                loss.backward()
        if outside:
            loss.backward()
        return [t.grad for t in tree_leaves(p)]

    inside = run_local_grid(lambda g: grads(g, False), (2,), ("data",),
                            "cpu")
    outside = run_local_grid(lambda g: grads(g, True), (2,), ("data",),
                             "cpu")
    for a_rank, b_rank in zip(inside, outside):
        for a, b in zip(a_rank, b_rank):
            assert torch.equal(a, b)
