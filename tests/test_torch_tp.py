"""The model axis of the port (``models/layers.py``): the fused
tensor-parallel down-projection and the sequence-parallel flash decode,
against the JAX package.

* ``swiglu`` with the fused TP route on a (2, 4) ("data", "model") grid
  of CPU rank threads (each rank its data block of the rows, the
  weights replicated): the summed loss ``sum(y * y)`` and the weight
  gradients (summed over the data ranks) against the reference's
  unfused ``jax.value_and_grad`` at the shapes and tolerances of
  ``tests/test_fused_multidev.py:111-137`` (b 8, s 16, d 32, f 64;
  forward rtol 1e-5, gradients rtol 1e-4 / atol 1e-4), through the
  engine's ``auto`` choice (the gathered path at this size, as in the
  reference) and through the ring itself (the engine's price made to
  favour it).  Off, and without a model axis, ``swiglu`` is the plain
  product.
* ``flash_decode`` on 8 model-rank threads, each holding its sequence
  block of the cache, against the reference's ``flash_decode`` under
  ``shard_map`` on an (8,) ("model",) mesh of virtual CPU devices
  (float32, 1e-6).
* The whole TP decode: reduced ``minicpm-2b`` (float32, 4 kv heads, so
  the cache is sequence-sharded over a model axis of 8), prefill through
  the fused route and greedy decode steps through ``flash_decode`` on 8
  rank threads, against the single-rank route: the same tokens, logits
  within 1e-5, each rank's cache block the single rank's positions.
* The ambient grid is per thread.

The JAX side runs once per file in a subprocess with 8 virtual CPU
devices and hands its results back as ``.npz``.
"""

import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import CollectiveEngine, run_local_grid
from repro_torch.collectives import shardmap_impl
from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import layers
from repro_torch.models.transformer import shard_decode_cache

ROOT = Path(__file__).resolve().parents[1]

B, S, D, F = 8, 16, 32, 64
#: flash_decode: batch, heads, kv heads (not a multiple of 8), head dim,
#: cache length (8 blocks of 8), and the kv lengths tried
FD = dict(b=2, h=4, kvh=2, d=16, s=64, kv_lens=(37, 64, 5))

_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.models import layers

    data = dict(np.load(sys.argv[1]))
    fd = eval(sys.argv[3])
    out = {}
    x = jnp.asarray(data["x"])
    params = tuple(jnp.asarray(data[k]) for k in ("wg", "wu", "wd"))

    def loss(params, x):
        y = layers.swiglu(x, *params)
        return jnp.sum(y * y)

    layers.set_fused_tp(False)
    val, grads = jax.value_and_grad(loss)(params, x)
    out["loss"] = np.asarray(val)
    for k, g in zip(("wg", "wu", "wd"), grads):
        out[f"grad_{k}"] = np.asarray(g)
    mesh = jax.make_mesh((8,), ("model",))
    for kv_len in fd["kv_lens"]:
        o = jax.jit(lambda q, k, v: layers.flash_decode(
            q, k, v, kv_len, mesh, None))(
                jnp.asarray(data["q"]), jnp.asarray(data["ck"]),
                jnp.asarray(data["cv"]))
        out[f"fd_{kv_len}"] = np.asarray(o)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"x": f(B, S, D), "wg": f(D, F) / np.float32(np.sqrt(D)),
            "wu": f(D, F) / np.float32(np.sqrt(D)),
            "wd": f(F, D) / np.float32(np.sqrt(F)),
            "q": f(FD["b"], 1, FD["h"], FD["d"]),
            "ck": f(FD["b"], FD["s"], FD["kvh"], FD["d"]),
            "cv": f(FD["b"], FD["s"], FD["kvh"], FD["d"])}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("jax_tp")
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npz"), repr(FD)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture
def fused_tp():
    layers.set_fused_tp(True)
    try:
        yield
    finally:
        layers.set_fused_tp(False)


def _swiglu_on_grid(inputs, shape=(2, 4), names=("data", "model")):
    """Each rank's (loss, weight grads, calls of the ring) over its data
    block of the rows."""
    n_dp = dict(zip(names, shape)).get("data", 1)
    rows = B // n_dp

    def fn(grid):
        d = grid.axis_index("data") if "data" in names else 0
        x = torch.from_numpy(inputs["x"][d * rows:(d + 1) * rows])
        ws = [torch.from_numpy(inputs[k]).requires_grad_()
              for k in ("wg", "wu", "wd")]
        with layers.ambient_grid(grid):
            y = layers.swiglu(x, *ws)
        loss = (y * y).sum()
        grads = torch.autograd.grad(loss, ws)
        return float(loss.detach()), [g.numpy() for g in grads]

    return run_local_grid(fn, shape, names, "cpu", timeout=120)


def _check_against_ref(got, ref, shape=(2, 4)):
    """Sum the data ranks (model rank 0 of each) and hold the sum to the
    reference's unfused value and gradients."""
    pm = shape[1]
    picks = got[::pm]
    loss = sum(l for l, _ in picks)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    for i, k in enumerate(("wg", "wu", "wd")):
        g = sum(gr[i] for _, gr in picks)
        np.testing.assert_allclose(g, ref[f"grad_{k}"], rtol=1e-4,
                                   atol=1e-4)
    # every model rank of a data row agrees on its rows' value
    for r in range(0, len(got), pm):
        for j in range(pm):
            assert abs(got[r + j][0] - got[r][0]) <= 1e-5 * abs(got[r][0])


@pytest.mark.parametrize("route", ["auto", "ring"])
def test_fused_swiglu_matches_reference_unfused(ref, inputs, fused_tp,
                                                monkeypatch, route):
    calls = []
    ring = shardmap_impl.fused_matmul_rs

    def counted(x, w, comm):
        calls.append(x.shape)
        return ring(x, w, comm)

    monkeypatch.setattr(shardmap_impl, "fused_matmul_rs", counted)
    if route == "ring":
        price = CollectiveEngine.price_fused_matmul_rs

        def favour_ring(self, *a, **k):
            return dict(price(self, *a, **k), saved=1.0)

        monkeypatch.setattr(CollectiveEngine, "price_fused_matmul_rs",
                            favour_ring)
    _check_against_ref(_swiglu_on_grid(inputs), ref)
    # the ring ran once per rank on its [rows * S, F / 4] block, or never
    want = [(B // 2 * S, F // 4)] * 8 if route == "ring" else []
    assert calls == want


def test_swiglu_off_or_without_model_axis_is_the_plain_product(ref, inputs,
                                                               fused_tp):
    _check_against_ref(_swiglu_on_grid(inputs, (8, 1), ("data", "model")),
                       ref, (8, 1))
    layers.set_fused_tp(False)
    _check_against_ref(_swiglu_on_grid(inputs), ref)


def test_fused_tp_applies_where_the_reference_does():
    def fn(grid):
        h = lambda b, s, f: torch.empty(b, s, f, device="meta")
        return (layers._fused_tp_applicable(grid, h(2, 4096, 5760)),
                layers._fused_tp_applicable(grid, h(2, 1, 5760)),
                layers._fused_tp_applicable(grid, h(8, 1, 5760)),
                layers._fused_tp_applicable(grid, h(2, 4, 60)))

    assert run_local_grid(fn, (8,), ("model",), "cpu")[0] == \
        (True, False, True, False)
    one = run_local_grid(fn, (8,), ("data",), "cpu")[0]
    assert one == (False,) * 4


@pytest.mark.parametrize("kv_len", FD["kv_lens"])
def test_flash_decode_matches_reference(ref, inputs, kv_len):
    blk = FD["s"] // 8

    def fn(grid):
        r = grid.axis_index("model")
        q = torch.from_numpy(inputs["q"])
        ck = torch.from_numpy(inputs["ck"][:, r * blk:(r + 1) * blk])
        cv = torch.from_numpy(inputs["cv"][:, r * blk:(r + 1) * blk])
        return layers.flash_decode(q, ck, cv, kv_len, grid)

    for out in run_local_grid(fn, (8,), ("model",), "cpu", timeout=60):
        np.testing.assert_allclose(out.numpy(), ref[f"fd_{kv_len}"],
                                   rtol=1e-6, atol=1e-6)


def test_use_flash_decode_follows_the_reference_rule():
    def fn(grid):
        with layers.ambient_grid(grid):
            return (layers.use_flash_decode(2, 1, 4104, 36) is grid,
                    layers.use_flash_decode(2, 1, 4104, 8) is None,
                    layers.use_flash_decode(2, 1, 4101, 36) is None,
                    layers.use_flash_decode(2, 4, 4104, 36) is None)

    assert run_local_grid(fn, (8,), ("model",), "cpu")[0] == (True,) * 4
    assert layers.use_flash_decode(2, 1, 4104, 36) is None   # no grid


def test_tp_prefill_and_decode_match_the_single_rank_route(fused_tp):
    import dataclasses
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                              .astype(np.int32))
    steps, headroom = 4, 8

    def greedy(cache, logits, grid):
        toks, outs = [], [logits]
        for _ in range(steps):
            nxt = outs[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(nxt)
            with layers.ambient_grid(grid):
                logits, cache = decode_step(params, cfg, cache,
                                            {"tokens": nxt})
            outs.append(logits)
        return torch.cat(toks, 1), torch.cat(outs, 1), cache

    def pad(cache):
        p = (0, 0, 0, 0, 0, headroom)
        return dict(cache, k=torch.nn.functional.pad(cache["k"], p),
                    v=torch.nn.functional.pad(cache["v"], p))

    with torch.no_grad():
        logits, cache = prefill(params, cfg, {"tokens": prompt})
        want_toks, want_logits, want_cache = greedy(pad(cache), logits, None)

    def fn(grid):
        with torch.no_grad():
            with layers.ambient_grid(grid):
                logits, cache = prefill(params, cfg, {"tokens": prompt})
            local = shard_decode_cache(cfg, pad(cache), grid)
            assert local["smax"] == 16 + headroom
            assert local["k"].shape[2] == (16 + headroom) // 8
            return greedy(local, logits, grid), grid.axis_index("model")

    blk = (16 + headroom) // 8
    for (toks, logits, cache), r in run_local_grid(fn, (8,), ("model",),
                                                   "cpu", timeout=120):
        assert torch.equal(toks, want_toks)
        np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                                   rtol=1e-5, atol=1e-5)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                cache[key].numpy(),
                want_cache[key][:, :, r * blk:(r + 1) * blk].numpy(),
                rtol=1e-5, atol=1e-6)


def test_ambient_grid_is_per_thread():
    seen = {}
    barrier = threading.Barrier(2, timeout=10)

    def worker(name):
        with layers.ambient_grid(name):
            barrier.wait()
            seen[name] = layers._ambient_grid()
        seen[name + "_after"] = layers._ambient_grid()

    threads = [threading.Thread(target=worker, args=(n,))
               for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"a": "a", "b": "b", "a_after": None, "b_after": None}
    assert layers._ambient_grid() is None


def test_cpu_backward_runs_on_the_calling_thread():
    """The CPU half of the autograd thread probe (its CUDA half is in
    ``tests/test_torch_gpu.py``): on the CPU each thread's backward nodes
    run on that thread, so a collective in a backward node would not
    deadlock here -- which is why the CPU tests cannot show the CUDA
    hazard the fused TP backward avoids."""
    seen = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen[threading.get_ident()] = True
            return g * 2

    callers = []
    # both threads alive until both are done: idents are not reused
    barrier = threading.Barrier(2, timeout=30)

    def worker():
        callers.append(threading.get_ident())
        x = torch.ones(4, requires_grad=True)
        barrier.wait()
        Probe.apply(x).sum().backward()
        barrier.wait()

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(set(callers)) == 2 and sorted(seen) == sorted(callers)


def test_tp_refusal_comes_before_the_remat_checkpoint(monkeypatch):
    """ROADMAP C34: a C15 refusal raised inside a checkpointed layer leaves
    torch's checkpoint generator suspended, its saved-tensor hooks pushed
    on the rank thread.  ``forward_train`` on a rank's tree refuses the
    backward it cannot run before it enters the first checkpoint (the
    refusal made to fire on the CPU here; it fires on CUDA rank threads
    only)."""
    from repro_torch.models import forward_train
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.rules import shard_params
    from repro_torch.tree import tree_map

    def refuse(x, grid, what):
        raise NotImplementedError(f"{what}: refused (C15)")

    entered = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint",
                        lambda *a, **k: entered.append(1) or real(*a, **k))
    monkeypatch.setattr(tf, "refuse_cuda_thread_backward", refuse)
    monkeypatch.setattr(layers, "refuse_cuda_thread_backward", refuse)
    cfg = get_config("yi-34b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)

    def rank(grid, remat):
        local = tree_map(lambda t: t.detach().requires_grad_(),
                         shard_params(params, cfg, grid))
        with layers.ambient_grid(grid):
            return forward_train(local, cfg, {"tokens": tokens},
                                 remat=remat)

    for remat in (True, False):
        with pytest.raises(NotImplementedError, match="C15"):
            run_local_grid(lambda g: rank(g, remat), (2,), ("model",),
                           "cpu", timeout=60)
    assert entered == []

