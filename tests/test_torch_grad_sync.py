"""Gradient sync through the paper's collectives (``train/step.py``'s
``GradSyncConfig``, ``fsdp_sync_apply`` and the DP train step) against
the JAX package.

* ``fsdp_sync_apply`` on a (2, 4) ("pod", "data") grid of CPU rank
  threads against the reference's on 8 virtual devices, on the same
  gradients, two calls (the step-0 tree-to-flat conversion, then flat
  state): the params, each rank's flat ``mu`` / ``nu`` shard against
  its block of the reference's global vectors, ``grad_norm``; with
  ``fused=True`` (the ``w=None`` reduce-scatter); and bf16 params with
  float32 master weights.  ``fsdp_state_to_tree`` of the gathered
  shards equals the reference's.  Within 1e-6 relative / 1e-7
  absolute: the same float32 arithmetic, which XLA fuses.
* The whole DP step of the tiny dense config of
  ``tests/test_engine.py:410-412`` (float32, batch 8 x 16) held to the
  reference's plain one-device ``make_train_step`` on the whole batch
  for two steps -- the reference's own anchor for its synced step
  (its DP step under GSPMD fails in the model under JAX 0.9, ROADMAP
  C2): on 8 rank threads over ("data",) (``allreduce``), on (2, 4)
  ("pod", "data") (``fsdp``, ``fsdp`` + ``fused``, ``allreduce``), and
  on 4 gloo processes as a 2 x 2 ``ProcessGroupGrid``, which give the
  same bits as 4 rank threads (under ``auto`` the loss mean is one
  native sum over the 4 ranks, which gloo adds in its own order: the
  loss within 1e-6 there, the params still bitwise).  Tolerances are the reference test's:
  params rtol 1e-4 / atol 1e-5, loss rtol 1e-5 / atol 1e-6, grad norm
  rtol 1e-4 / atol 1e-6, bf16 params with masters 1e-2.
* The launcher: ``--dp`` under ``torch.distributed.run`` with 4 gloo
  processes (``--device cpu``), in both sync modes, gives the losses of
  the run without ``--dp``: the first within 1e-6 (the mean over the
  ranks' rows), the later ones within 1e-4 (reduced ``minicpm-2b`` is a
  bf16 model: 2-row bf16 gradients reduced in float32 against one 8-row
  bf16 backward); without a GPU and without ``--device cpu`` it raises.
* ``GradSyncConfig`` refuses an unknown mode; a rank that raises in the
  DP step releases the grid.

The JAX side runs once per file in a subprocess with 8 virtual CPU
devices and hands its results back as ``.npz``.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import run_local_grid
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import fsdp_state_to_tree, init_train_state
from repro_torch.train.step import (GradSyncConfig, fsdp_sync_apply,
                                    make_train_step)
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]

CFG_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              dtype="float32")
CFG = ArchConfig(**CFG_KW)
OPT = dict(warmup_steps=1, total_steps=10)
BATCH = (8, 16)
STEPS = 2
TOL = dict(params=(1e-4, 1e-5), loss=(1e-5, 1e-6), gnorm=(1e-4, 1e-6),
           master=(1e-2, 1e-2))
#: fsdp_sync_apply on the same gradients: the same float32 arithmetic,
#: which XLA fuses (a few elements differ in the last bit); bf16 params
#: are the masters rounded, so one bf16 ulp where a master sits on a
#: rounding boundary
FSDP_RTOL, FSDP_ATOL = 1e-6, 1e-7
BF16_ULP = 2.0 ** -8 * 4

_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.models import init_params
    from repro.optim.adamw import AdamWConfig
    from repro.train.state import init_train_state, fsdp_state_to_tree
    from repro.train.step import (GradSyncConfig, fsdp_sync_apply,
                                  make_train_step)

    cfg_kw, opt_kw, steps = eval(sys.argv[3])
    data = dict(np.load(sys.argv[1]))
    cfg = ArchConfig(**cfg_kw)
    opt = AdamWConfig(**opt_kw)
    params = init_params(jax.random.PRNGKey(0), cfg)
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) for p in path)
            out[f"{prefix}|{key}"] = np.asarray(leaf, np.float32)

    put("init", params)
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "labels": jnp.asarray(data["labels"])}
    # the plain one-device step on the whole batch, float32 and bf16
    # params with float32 masters
    step = jax.jit(make_train_step(cfg, opt))
    for tag, st in (("plain", init_train_state(params)),
                    ("plain_master", init_train_state(
                        jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                                     params), master_weights=True))):
        for i in range(steps):
            st, m = step(st, batch)
            out[f"{tag}|loss|{i}"] = np.asarray(m["loss"])
            out[f"{tag}|gnorm|{i}"] = np.asarray(m["grad_norm"])
        put(f"{tag}|params", st.params)
    # fsdp_sync_apply on (2, 4) over ("pod", "data") on given gradients
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    leaves, treedef = jax.tree.flatten(params)
    grads = []
    for i in range(steps):
        flat, off, gl = data[f"grads{i}"], 0, []
        for leaf in leaves:
            gl.append(jnp.asarray(flat[off:off + leaf.size]
                                  .reshape(leaf.shape)))
            off += leaf.size
        grads.append(jax.tree.unflatten(treedef, gl))
    for tag, fused, master in (("fsdp", False, False),
                               ("fsdp_fused", True, False),
                               ("fsdp_master", False, True)):
        gs = GradSyncConfig(mesh=mesh, axes=("pod", "data"), mode="fsdp",
                            fused=fused)
        p = params
        if master:
            p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        st = init_train_state(p, master_weights=master)
        # eager: under jit JAX 0.9 refuses the scalars (lr, bias
        # corrections) that the shard_map body closes over
        pp, oo = st.params, st.opt
        for i in range(steps):
            pp, oo, m = fsdp_sync_apply(opt, pp, grads[i], oo, gs)
            out[f"{tag}|gnorm|{i}"] = np.asarray(m["grad_norm"])
            out[f"{tag}|lr|{i}"] = np.asarray(m["lr"])
        put(f"{tag}|params", pp)
        out[f"{tag}|mu"] = np.asarray(oo.mu)
        out[f"{tag}|nu"] = np.asarray(oo.nu)
        if master:
            out[f"{tag}|master"] = np.asarray(oo.master)
        # on one device: the helper's slicing of the explicitly
        # sharded vector raises under JAX 0.9
        host = oo._replace(mu=jnp.asarray(np.asarray(oo.mu)),
                           nu=jnp.asarray(np.asarray(oo.nu)), master=None)
        back = fsdp_state_to_tree(init_train_state(pp)._replace(opt=host))
        put(f"{tag}|mu_tree", back.opt.mu)
    np.savez(sys.argv[2], **out)
""")


def _batch_numpy():
    rng = np.random.default_rng(1)
    return {"tokens": rng.integers(0, CFG.vocab_size, BATCH).astype(np.int32),
            "labels": rng.integers(0, CFG.vocab_size, BATCH).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_grad_sync")
    rng = np.random.default_rng(2)
    data = dict(_batch_numpy())
    for i in range(STEPS):
        data[f"grads{i}"] = (rng.normal(size=(1 << 16,)) * 0.1
                             ).astype(np.float32)
    np.savez(tmp / "inputs.npz", **data)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npz"), repr((CFG_KW, OPT, STEPS))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = dict(np.load(tmp / "out.npz"))
    out["data"] = data
    return out


def _tree(ref, prefix, dtype=None):
    """A reference tree saved under ``prefix`` as the port's params."""
    tree = {"layers": {}}
    for key, arr in ref.items():
        if key.startswith(prefix + "|"):
            path = key[len(prefix) + 1:].split("/")
            if len(path) == 2:
                tree["layers"][path[1]] = arr
            else:
                tree[path[0]] = arr
    params = params_from_jax(tree, CFG, "cpu")
    return params if dtype is None else tree_map(
        lambda p: p.to(dtype), params)


def _stacked_leaves(params):
    """The port's params as the reference's stacked leaves, in its
    flatten order."""
    out = []
    for k in sorted(params):
        if k == "layers":
            for n in sorted(params["layers"][0]):
                out.append(np.stack([lp[n].float().numpy()
                                     for lp in params["layers"]]))
        else:
            out.append(params[k].float().numpy())
    return out


def _ref_leaves(ref, prefix):
    keys = sorted(k for k in ref if k.startswith(prefix + "|"))
    return [ref[k] for k in keys]


def _assert_params(got, ref, prefix, tol):
    rtol, atol = tol
    for a, b in zip(_stacked_leaves(got), _ref_leaves(ref, prefix)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _grads(ref, i, like):
    flat = torch.from_numpy(ref["data"][f"grads{i}"])
    from repro_torch.tree import unflatten_stacked
    n = sum(p.numel() for p in tree_leaves(like))
    return unflatten_stacked(like, flat[:n], [torch.float32] *
                             len(tree_leaves(like)))


# ---------------------------- fsdp_sync_apply ---------------------------- #
@pytest.mark.parametrize("tag", ["fsdp", "fsdp_fused", "fsdp_master"])
def test_fsdp_sync_apply_matches_reference(ref, tag):
    master = tag == "fsdp_master"
    dtype = torch.bfloat16 if master else None
    opt = AdamWConfig(**OPT)

    def fn(grid):
        params = _tree(ref, "init", dtype)
        gs = GradSyncConfig(grid=grid, axes=("pod", "data"), mode="fsdp",
                            fused=tag == "fsdp_fused")
        st = init_train_state(params, master_weights=master)
        p, o = st.params, st.opt
        norms = []
        for i in range(STEPS):
            p, o, m = fsdp_sync_apply(opt, p, _grads(ref, i, p), o, gs)
            norms.append((float(m["grad_norm"]), m["lr"]))
        return p, o, norms

    got = run_local_grid(fn, (2, 4), ("pod", "data"), "cpu", timeout=120)
    shard = got[0][1].mu.numel()
    mus, nus = [], []
    for rank, (p, o, norms) in enumerate(got):
        if master:
            _assert_params(p, ref, f"{tag}|params", (0, BF16_ULP))
            assert all(x.dtype == torch.bfloat16 for x in tree_leaves(p))
            assert o.master.dtype == torch.float32 and o.master.dim() == 1
            np.testing.assert_allclose(
                o.master.numpy(),
                ref[f"{tag}|master"][rank * shard:(rank + 1) * shard],
                rtol=FSDP_RTOL, atol=FSDP_ATOL)
        else:
            _assert_params(p, ref, f"{tag}|params", (FSDP_RTOL, FSDP_ATOL))
        for i, (gn, lr) in enumerate(norms):
            np.testing.assert_allclose(gn, ref[f"{tag}|gnorm|{i}"],
                                       rtol=FSDP_RTOL, atol=0)
            assert np.float32(lr) == ref[f"{tag}|lr|{i}"]
        for name, mine in (("mu", o.mu), ("nu", o.nu)):
            want = ref[f"{tag}|{name}"][rank * shard:(rank + 1) * shard]
            np.testing.assert_allclose(mine.numpy(), want, rtol=FSDP_RTOL,
                                       atol=FSDP_ATOL)
        mus.append(o.mu)
        nus.append(o.nu)
    # the gathered flat state back to the tree, as the reference's helper
    p0, o0, _ = got[0]
    state = init_train_state(p0)._replace(opt=o0._replace(
        mu=torch.cat(mus), nu=torch.cat(nus),
        master=None))
    back = fsdp_state_to_tree(state)
    for a, b in zip(_stacked_leaves(back.opt.mu),
                    _ref_leaves(ref, f"{tag}|mu_tree")):
        np.testing.assert_allclose(a, b, rtol=FSDP_RTOL, atol=FSDP_ATOL)
    assert fsdp_state_to_tree(back) .opt.mu is back.opt.mu


# ------------------------------ DP steps -------------------------------- #
def _batch_rows(rank, n):
    b = {k: torch.from_numpy(v) for k, v in _batch_numpy().items()}
    per = BATCH[0] // n
    return {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}


def _dp_run(ref, shape, names, axes, mode, fused=False, master=False,
            algorithm="auto"):
    opt = AdamWConfig(**OPT)
    n = int(np.prod(shape))

    def fn(grid):
        params = _tree(ref, "init", torch.bfloat16 if master else None)
        gs = GradSyncConfig(grid=grid, axes=axes, mode=mode, fused=fused,
                            algorithm=algorithm)
        step = make_train_step(CFG, opt, grad_sync=gs)
        st = init_train_state(params, master_weights=master)
        ms = []
        for _ in range(STEPS):
            st, m = step(st, _batch_rows(grid.rank, n))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        return st.params, ms

    return run_local_grid(fn, shape, names, "cpu", timeout=120)


DP_CASES = {"allreduce_8": ((8,), ("data",), ("data",), "allreduce", False),
            "allreduce_24": ((2, 4), ("pod", "data"), ("pod", "data"),
                             "allreduce", False),
            "fsdp_24": ((2, 4), ("pod", "data"), ("pod", "data"), "fsdp",
                        False),
            "fsdp_fused_24": ((2, 4), ("pod", "data"), ("pod", "data"),
                              "fsdp", True)}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_step_matches_reference_plain_step(ref, case):
    shape, names, axes, mode, fused = DP_CASES[case]
    for params, ms in _dp_run(ref, shape, names, axes, mode, fused):
        _assert_params(params, ref, "plain|params", TOL["params"])
        for i, (loss, gnorm) in enumerate(ms):
            np.testing.assert_allclose(loss, ref[f"plain|loss|{i}"],
                                       rtol=TOL["loss"][0],
                                       atol=TOL["loss"][1])
            np.testing.assert_allclose(gnorm, ref[f"plain|gnorm|{i}"],
                                       rtol=TOL["gnorm"][0],
                                       atol=TOL["gnorm"][1])


@pytest.mark.parametrize("mode", ["allreduce", "fsdp"])
def test_dp_step_bf16_with_masters_tracks_reference(ref, mode):
    got = _dp_run(ref, (2, 4), ("pod", "data"), ("pod", "data"), mode,
                  master=True)
    for params, _ in got:
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
        _assert_params(params, ref, "plain_master|params", TOL["master"])


#: (mode, algorithm) of the gloo run: 2d_snake adds in a fixed order on
#: any backend; auto takes natives over the folded 4 ranks for the loss
#: and the grad norm (the updates do not move: the norm stays under the
#: clip)
GLOO_MODES = (("allreduce", "2d_snake"), ("fsdp", "auto"))

_GLOO_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[5])
    import test_torch_grad_sync as t
    from repro_torch.collectives import ProcessGroupGrid
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import GradSyncConfig, make_train_step
    from repro_torch.tree import tree_leaves

    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    grid = ProcessGroupGrid((2, 2), ("pod", "data"), device="cpu")
    res = {}
    for mode, alg in t.GLOO_MODES:
        ref = {k: v for k, v in np.load(sys.argv[6]).items()}
        params = t._tree(ref, "init")
        gs = GradSyncConfig(grid=grid, axes=("pod", "data"), mode=mode,
                            algorithm=alg)
        step = make_train_step(t.CFG, AdamWConfig(**t.OPT), grad_sync=gs)
        st = init_train_state(params)
        for i in range(t.STEPS):
            st, m = step(st, t._batch_rows(rank, world))
            res[f"{mode}|loss|{i}"] = np.asarray(float(m["loss"]))
        for j, leaf in enumerate(tree_leaves(st.params)):
            res[f"{mode}|p|{j}"] = leaf.numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")


def test_dp_step_on_gloo_processes_equals_rank_threads(ref, tmp_path):
    world = 4
    np.savez(tmp_path / "init.npz",
             **{k: v for k, v in ref.items() if k.startswith("init|")})
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), str(world), init,
         str(tmp_path / f"out{r}.npz"), str(ROOT / "tests"),
         str(tmp_path / "init.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    for mode, alg in GLOO_MODES:
        threads = _dp_run(ref, (2, 2), ("pod", "data"), ("pod", "data"),
                          mode, algorithm=alg)
        for r in range(world):
            got = dict(np.load(tmp_path / f"out{r}.npz"))
            params, ms = threads[r]
            for i, (loss, _) in enumerate(ms):
                want = np.float32(loss)
                if alg == "auto":
                    # auto's loss mean is one native sum over the 4
                    # ranks, which gloo adds in its own order
                    np.testing.assert_allclose(got[f"{mode}|loss|{i}"],
                                               want, rtol=1e-6, atol=0)
                else:
                    assert got[f"{mode}|loss|{i}"] == want, (mode, r, i)
            for j, leaf in enumerate(tree_leaves(params)):
                assert np.array_equal(got[f"{mode}|p|{j}"], leaf.numpy()), \
                    (mode, r, j)
            _assert_params(params, ref, "plain|params", TOL["params"])


# ------------------------------- contract -------------------------------- #
def test_grad_sync_config_refuses_an_unknown_mode():
    grid = object()
    with pytest.raises(ValueError, match="unknown grad-sync mode"):
        GradSyncConfig(grid=grid, mode="gspmd")
    assert GradSyncConfig(grid=grid, mode="fsdp").bucket_bytes == 4 << 20


def test_a_failing_rank_releases_the_dp_step(ref):
    opt = AdamWConfig(**OPT)

    def fn(grid):
        gs = GradSyncConfig(grid=grid, axes=("pod", "data"), mode="fsdp")
        step = make_train_step(CFG, opt, grad_sync=gs)
        batch = _batch_rows(grid.rank, 8)
        if grid.rank == 5:
            batch["tokens"] = batch["tokens"][:, :3]   # labels mismatch
        return step(init_train_state(_tree(ref, "init")), batch)

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        run_local_grid(fn, (2, 4), ("pod", "data"), "cpu", timeout=60)
    assert time.perf_counter() - t0 < 30


# ------------------------------- launcher -------------------------------- #
_TORCHRUN_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np
    from repro_torch.launch import train

    out, mode = sys.argv[1], sys.argv[2]
    losses = train.main(["--arch", "minicpm-2b", "--reduced", "--steps",
                         "3", "--batch", "8", "--seq", "32", "--dp",
                         "--grad-sync", mode, "--device", "cpu"])
    import os
    np.save(f"{out}.{os.environ['RANK']}.npy", np.asarray(losses))
""")


@pytest.mark.parametrize("mode", ["allreduce", "fsdp"])
def test_launcher_dp_under_torchrun_matches_single_process(tmp_path, mode):
    from repro_torch.launch import train
    script = tmp_path / "dp_train.py"
    script.write_text(_TORCHRUN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    # a session of its own: on a timeout the whole group goes, torchrun's
    # workers included
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(script), str(tmp_path / "losses"),
         mode], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp_path, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    assert "dp grid {'pod': 2, 'data': 2}" in out
    want = train.run("minicpm-2b", 3, 8, 32, device="cpu")
    for r in range(4):
        got = np.load(tmp_path / f"losses.{r}.npy")
        # step 0 is the same loss; later steps follow updates from
        # bf16 gradients of 2-row blocks, reduced in float32 buckets,
        # where the single process has one 8-row bf16 backward
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_launcher_dp_without_gpu_needs_device_cpu():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "minicpm-2b", "--reduced", "--steps", "1",
                    "--dp"])


def test_launcher_fabric_spec_installs_a_topology_engine(capsys):
    """``--fabric`` plans the sync against the declared per-axis links:
    the engine the step then gets prices with the parsed topology."""
    from repro_torch.collectives import api
    from repro_torch.launch import train
    saved = dict(api._ENGINES)
    try:
        losses = train.main(["--arch", "minicpm-2b", "--reduced",
                             "--steps", "1", "--batch", "2", "--seq", "16",
                             "--dp", "--fabric", "pod=slow,data=fast",
                             "--device", "cpu"])
        topo = api.get_engine(device="cpu").topology
        assert topo.for_axis("pod") != topo.for_axis("data")
    finally:
        api._ENGINES.clear()
        api._ENGINES.update(saved)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "[train] fabric topology:" in capsys.readouterr().out
