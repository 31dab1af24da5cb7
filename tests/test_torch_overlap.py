"""The port's bucketed gradient AllReduce (``collectives/overlap.py``)
against the JAX package's.

* ``bucketed_allreduce`` on ``run_local_grid`` CPU ranks, every rank
  holding the same gradient tree (the reference's input is one
  replicated array under ``shard_map``): float32 bitwise equal to the
  reference on ("data",) with ``ring`` and ``auto`` (buckets of 2 KB,
  8 KB and one bucket), without the mean, and over ("pod", "data") with the 2D
  plans; with ``compress=True`` and an error feedback, the bf16 results
  and the residuals bitwise equal on ("data",) ``ring`` (the bf16
  natives, ROADMAP C4), and within the reference's own tolerance (1e-2
  relative, ``tests/test_collectives_multidev.py``) over ("pod",
  "data") under ``auto``.  The flat vector follows the reference's
  stacked order, so its buckets cut the same elements.
* ``bucket_algorithm_plan`` returns ``==`` the reference's list for the
  tiny tree and the full ``minicpm-2b`` tree on one and two axes.
* Distinct per-rank gradients: the mean over ranks, against numpy.
* ``flatten_tree`` / ``unflatten_tree`` round-trip in stacked order.

The JAX side runs once per file in a subprocess with 8 virtual CPU
devices and hands its results back as ``.npz``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import CollectiveEngine, run_local_grid
from repro_torch.collectives.overlap import (bucket_algorithm_plan,
                                             bucketed_allreduce,
                                             flatten_tree, unflatten_tree)
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import init_params
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]

CFG = ArchConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                 num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                 dtype="float32")
MESHES = {"8": ((8,), ("data",)), "24": ((2, 4), ("pod", "data")),
          "222": ((2, 2, 2), ("pod", "data", "model"))}
#: label -> (mesh, axes, algorithm, bucket_bytes, compress, mean)
CASES = {
    "ring_2k": ("8", ("data",), "ring", 2048, False, True),
    "ring_one_bucket": ("8", ("data",), "ring", 1 << 30, False, True),
    "auto_8k": ("8", ("data",), "auto", 8192, False, True),
    "ring_sum": ("8", ("data",), "ring", 8192, False, False),
    "pd_snake": ("24", ("pod", "data"), "2d_snake", 8192, False, True),
    "pd_xy": ("24", ("pod", "data"), "2d_xy", 8192, False, True),
    "pd_hier": ("24", ("pod", "data"), "hierarchical", 8192, False, True),
    "ring_compress": ("8", ("data",), "ring", 2048, True, True),
    "pd_auto_compress": ("24", ("pod", "data"), "auto", 2048, True, True),
}
BITWISE = [c for c in CASES if c != "pd_auto_compress"]
#: (mesh, axes, bucket_bytes) for bucket_algorithm_plan
PLANS = [("8", ("data",), 2048), ("8", ("data",), 4 << 20),
         ("24", ("pod", "data"), 2048), ("24", ("pod", "data"), 4 << 20),
         ("222", ("pod", "data"), 4 << 20)]
PLAN_ARCH = "minicpm-2b"


def _grads_numpy():
    """The tiny config's gradient-shaped tree in the reference's stacked
    layout (normal values) and an error feedback of the same shapes."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    d, f_, v, L = CFG.d_model, CFG.d_ff, CFG.vocab_size, CFG.num_layers
    g = {"embed": f(v, d), "ln_f": f(d), "head": f(d, v),
         "layers": {"ln1": f(L, d), "ln2": f(L, d), "wq": f(L, d, d),
                    "wk": f(L, d, d), "wv": f(L, d, d), "wo": f(L, d, d),
                    "wg": f(L, d, f_), "wu": f(L, d, f_),
                    "wd": f(L, f_, d)}}
    e = {k: (None if k == "layers" else f(*x.shape) * 1e-3)
         for k, x in g.items()}
    e["layers"] = {k: f(*x.shape) * 1e-3 for k, x in g["layers"].items()}
    return g, e


def _stacked(tree):
    """The port's tree as the reference's stacked numpy tree."""
    out = {k: v.numpy() for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: np.stack([lp[k].numpy() for lp in tree["layers"]])
                     for k in tree["layers"][0]}
    return out


def _keys(tree):
    return [f"{k}/{n}" for k, v in sorted(tree.items())
            for n in (sorted(v) if isinstance(v, dict) else [""])]


def _get(tree, key):
    k, n = key.split("/")
    return tree[k][n] if n else tree[k]


_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.collectives.engine import CollectiveEngine
    from repro.collectives.overlap import (bucketed_allreduce,
                                           bucket_algorithm_plan)
    from repro.configs import get_config
    from repro.models import param_specs

    cases, meshes, plans, plan_arch = eval(sys.argv[3])
    data = dict(np.load(sys.argv[1]))
    grads = {"embed": None, "head": None, "ln_f": None, "layers": {}}
    errs = {"embed": None, "head": None, "ln_f": None, "layers": {}}
    for key, arr in data.items():
        kind, k, n = key.split("/")
        tree = grads if kind == "g" else errs
        if n:
            tree[k][n] = jnp.asarray(arr)
        else:
            tree[k] = jnp.asarray(arr)
    def name(path):
        key = "/".join(str(p.key) for p in path)
        return key if "/" in key else key + "/"

    out = {}
    for label, (mesh, axes, alg, bb, compress, mean) in cases.items():
        shape, names = meshes[mesh]
        m = jax.make_mesh(shape, names)
        eng = CollectiveEngine(persist=False)
        red, ef = jax.jit(lambda g, e: bucketed_allreduce(
            g, m, axes=axes, algorithm=alg, bucket_bytes=bb,
            compress=compress, mean=mean, engine=eng,
            error_feedback=e if compress else None))(grads, errs)
        for path, leaf in jax.tree_util.tree_flatten_with_path(red)[0]:
            out[f"{label}|red|{name(path)}"] = np.asarray(leaf)
        if ef is not None:
            for path, leaf in jax.tree_util.tree_flatten_with_path(ef)[0]:
                out[f"{label}|ef|{name(path)}"] = np.asarray(leaf)
    big = param_specs(get_config(plan_arch))
    eng = CollectiveEngine(persist=False)
    for i, (mesh, axes, bb) in enumerate(plans):
        shape, names = meshes[mesh]
        m = jax.make_mesh(shape, names)
        for which, tree in (("tiny", grads), ("big", big)):
            if which == "big" and bb < (1 << 20):
                continue        # ~10^6 buckets: the plan of small ones
            plan = bucket_algorithm_plan(tree, m, axes=axes,
                                         bucket_bytes=bb, engine=eng)
            out[f"plan|{i}|{which}"] = np.array(repr(plan))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    return _grads_numpy()


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    g, e = inputs
    tmp = tmp_path_factory.mktemp("jax_overlap")
    flat = {}
    for tag, tree in (("g", g), ("e", e)):
        for k, v in tree.items():
            if k == "layers":
                for n, a in v.items():
                    flat[f"{tag}/{k}/{n}"] = a
            else:
                flat[f"{tag}/{k}/"] = v
    np.savez(tmp / "inputs.npz", **flat)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npz"), repr((CASES, MESHES, PLANS, PLAN_ARCH))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _port_tree(tree):
    return params_from_jax(tree, CFG, "cpu")


def _run(label, inputs):
    mesh, axes, alg, bb, compress, mean = CASES[label]
    shape, names = MESHES[mesh]
    g, e = inputs

    def fn(grid):
        eng = CollectiveEngine(persist=False, device="cpu")
        return bucketed_allreduce(
            _port_tree(g), grid, axes=axes, algorithm=alg, bucket_bytes=bb,
            compress=compress, mean=mean, engine=eng,
            error_feedback=_port_tree(e) if compress else None)

    return run_local_grid(fn, shape, names, "cpu", timeout=120)


@pytest.mark.parametrize("label", BITWISE)
def test_bucketed_allreduce_bitwise_equal_to_reference(ref, inputs, label):
    compress = CASES[label][4]
    g = inputs[0]
    for rank, (red, ef) in enumerate(_run(label, inputs)):
        red = _stacked(red)
        for key in _keys(g):
            want = ref[f"{label}|red|{key}"]
            got = _get(red, key)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (label, rank, key)
        assert (ef is None) == (not compress)
        if compress:
            ef = _stacked(ef)
            for key in _keys(g):
                assert np.array_equal(_get(ef, key),
                                      ref[f"{label}|ef|{key}"]), \
                    (label, rank, key)


def test_compressed_two_axis_within_reference_tolerance(ref, inputs):
    label = "pd_auto_compress"
    g = inputs[0]
    for red, ef in _run(label, inputs):
        red, ef = _stacked(red), _stacked(ef)
        for key in _keys(g):
            np.testing.assert_allclose(_get(red, key),
                                       ref[f"{label}|red|{key}"],
                                       rtol=1e-2, atol=1e-2)
            np.testing.assert_allclose(_get(ef, key),
                                       ref[f"{label}|ef|{key}"],
                                       rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_bucket_plan_equals_reference(ref, inputs, i):
    mesh, axes, bb = PLANS[i]
    shape, names = MESHES[mesh]
    eng = CollectiveEngine(persist=False, device="cpu")
    trees = {"tiny": _port_tree(inputs[0]),
             "big": init_params(get_config(PLAN_ARCH), device="meta")}
    for which, tree in trees.items():
        if which == "big" and bb < (1 << 20):
            continue
        got = bucket_algorithm_plan(tree, (names, shape), axes=axes,
                                    bucket_bytes=bb, engine=eng)
        assert got == eval(str(ref[f"plan|{i}|{which}"])), (i, which)


@pytest.mark.parametrize("alg", ["ring", "auto", "2d_snake"])
def test_distinct_rank_gradients_average(alg):
    rng = np.random.default_rng(3)
    gs = [rng.normal(size=(1000,)).astype(np.float32) for _ in range(8)]
    axes = ("data",) if alg != "2d_snake" else ("pod", "data")
    shape = (8,) if alg != "2d_snake" else (2, 4)
    names = ("data",) if alg != "2d_snake" else ("pod", "data")

    def fn(grid):
        eng = CollectiveEngine(persist=False, device="cpu")
        tree = {"a": torch.from_numpy(gs[grid.rank][:600].reshape(20, 30)),
                "b": [torch.from_numpy(gs[grid.rank][600:])]}
        return bucketed_allreduce(tree, grid, axes=axes, algorithm=alg,
                                  bucket_bytes=512, engine=eng)[0]

    want = np.mean(np.stack(gs), axis=0)
    for out in run_local_grid(fn, shape, names, "cpu", timeout=60):
        got = np.concatenate([out["a"].numpy().ravel(),
                              out["b"][0].numpy()])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_flat_vector_follows_the_stacked_order():
    tree = init_params(CFG, seed=0, device="cpu")
    flat, meta = flatten_tree(tree)
    stacked = _stacked(tree)
    want = np.concatenate([_get(stacked, k).ravel() for k in _keys(stacked)])
    assert np.array_equal(flat.numpy(), want)
    back = unflatten_tree(flat * 2, meta)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b * 2)


@pytest.mark.parametrize("pad", [0, 5])
def test_flat_span_is_the_slice_of_the_flat_vector(pad):
    """``flatten_stacked(span=...)``, which builds an FSDP shard without
    the whole vector, is the slice of the whole padded vector."""
    from repro_torch.tree import flatten_stacked
    tree = init_params(CFG, seed=1, device="cpu")
    full = flatten_stacked(tree, pad=pad)
    n = full.numel()
    for lo, hi in [(0, n), (0, 1), (n // 3, 2 * n // 3), (n - 7, n),
                   (2048, 2048 + 33)]:
        assert torch.equal(flatten_stacked(tree, pad=pad, span=(lo, hi)),
                           full[lo:hi])
    with pytest.raises(ValueError, match="span"):
        flatten_stacked(tree, pad=pad, span=(0, n + 1))
