"""The port's per-rank collectives against the JAX package's.

* Every single-axis op x algorithm of the engine, on 8 ``LocalComm``
  ranks, bitwise equal on every rank to the JAX engine under
  ``shard_map`` on 8 virtual CPU devices (random float32 inputs; forced
  algorithms and ``auto`` at two sizes).  The JAX side runs once per
  file in a subprocess with ``--xla_force_host_platform_device_count=8``,
  as the reference's own multi-device tests do, and hands its results
  back as ``.npz``.
* The fused matmul + ring reduce-scatter against the JAX ring and its
  gathered path (float32; the block GEMMs are different BLAS calls, so
  1e-5).
* Integer-valued inputs, exact against numpy, at P in {2, 3, 5, 8}
  (float32 and bfloat16: every order of adds is exact).
* ``ProcessGroupComm`` on 4 gloo processes: the same bits as
  ``LocalComm``.
* The communicators' own contract (``ppermute`` zeros, bad rounds,
  errors in a rank).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import (CollectiveEngine, ProcessGroupComm,
                                     run_local)
from repro_torch.collectives import shardmap_impl as impl
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
P = 8

ALGORITHMS = {
    "reduce": ["chain", "tree", "two_phase", "star", "autogen",
               "autogen_pipelined", "auto"],
    "allreduce": ["psum", "oneshot", "chain", "tree", "two_phase", "star",
                  "ring", "autogen", "autogen_pipelined", "auto"],
    "reduce_scatter": ["psum_scatter", "ring", "autogen", "auto"],
    "allgather": ["all_gather", "oneshot", "ring", "doubling", "autogen",
                  "auto"],
    "broadcast": ["doubling", "chain", "autogen", "auto"],
    "all_to_all": ["lax", "oneshot", "ring", "halving", "auto"],
}
CASES = [(op, alg) for op, algs in ALGORITHMS.items() for alg in algs]
#: per-rank shapes: 768 B (auto takes the latency regime) and 256 KB
#: (auto takes the bandwidth algorithms); leading dims divisible by P
SHAPES = {"small": (64, 3), "large": (2048, 32)}
BROADCAST_ROOT = 3
FUSED = dict(m=32, k=24, n=16)          # per rank: x [32, 24], w [24, 16]

_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.collectives.engine import CollectiveEngine
    from repro.kernels import fused_matmul_rs as fk

    algorithms, shapes, root, fused = eval(sys.argv[2])
    eng = CollectiveEngine(persist=False)
    mesh = jax.make_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    out = {}

    def run(f, *arrays):
        sm = shard_map(lambda *v: f(*[a[0] for a in v])[None], mesh=mesh,
                       in_specs=(P("data"),) * len(arrays),
                       out_specs=P("data"), check_rep=False)
        return np.asarray(jax.jit(sm)(*arrays))

    for size, shape in shapes.items():
        xs = rng.normal(size=(8,) + shape).astype(np.float32)
        out[f"x/{size}"] = xs
        for op, algs in algorithms.items():
            fn = getattr(eng, op + "_inside")
            for alg in algs:
                if size == "large" and alg != "auto":
                    continue
                if op == "broadcast":
                    f = lambda v, fn=fn, alg=alg: fn(v, "data", root, alg)
                else:
                    f = lambda v, fn=fn, alg=alg: fn(v, "data", alg)
                out[f"{op}/{alg}/{size}"] = run(f, xs)
    m, k, n = fused["m"], fused["k"], fused["n"]
    x = rng.normal(size=(8, m, k)).astype(np.float32)
    w = rng.normal(size=(8, k, n)).astype(np.float32)
    out["fused/x"], out["fused/w"] = x, w
    out["fused/ring"] = run(
        lambda a, b: fk.fused_matmul_rs(a, b, "data", interpret=True), x, w)
    out["fused/engine_fused"] = run(
        lambda a, b: eng.fused_matmul_reduce_scatter(
            a, b, "data", algorithm="fused"), x, w)
    out["fused/engine_unfused"] = run(
        lambda a, b: eng.fused_matmul_reduce_scatter(
            a, b, "data", algorithm="unfused"), x, w)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_collectives")
    path = tmp / "results.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    args = repr((ALGORITHMS, SHAPES, BROADCAST_ROOT, FUSED))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(path),
                           args], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def engine():
    return CollectiveEngine(persist=False, device="cpu")


def _run_op(engine, op, alg, xs, p=P, root=BROADCAST_ROOT):
    fn = getattr(engine, op + "_inside")
    if op == "broadcast":
        call = lambda c: fn(xs[c.rank], c, root, alg)
    else:
        call = lambda c: fn(xs[c.rank], c, alg)
    return run_local(call, p, "cpu")


# -------------------- bitwise parity with the JAX engine ----------------- #
@pytest.mark.parametrize("op,alg", CASES)
def test_local_ranks_bitwise_equal_to_jax_engine(jax_results, engine, op,
                                                 alg):
    sizes = ["small", "large"] if alg == "auto" else ["small"]
    for size in sizes:
        xs = [torch.from_numpy(a) for a in jax_results[f"x/{size}"]]
        got = _run_op(engine, op, alg, xs)
        want = jax_results[f"{op}/{alg}/{size}"]
        for rank, g in enumerate(got):
            assert g.dtype == torch.float32
            assert g.shape == want[rank].shape, (rank, g.shape)
            assert np.array_equal(g.numpy(), want[rank]), \
                (op, alg, size, rank, np.abs(g.numpy() - want[rank]).max())


@pytest.mark.parametrize("path", ["ring", "engine_fused",
                                  "engine_unfused"])
def test_fused_matmul_rs_matches_jax(jax_results, engine, path):
    x = torch.from_numpy(jax_results["fused/x"])
    w = torch.from_numpy(jax_results["fused/w"])
    if path == "ring":
        fn = lambda c: impl.fused_matmul_rs(x[c.rank], w[c.rank], c)
    else:
        alg = "fused" if path == "engine_fused" else "unfused"
        fn = lambda c: engine.fused_matmul_reduce_scatter(
            x[c.rank], w[c.rank], c, algorithm=alg)
    got = np.stack([g.numpy() for g in run_local(fn, P, "cpu")])
    want = jax_results[f"fused/{path}"]
    assert got.shape == want.shape == (P, FUSED["m"] // P, FUSED["n"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    full = np.einsum("pmk,pkn->mn", jax_results["fused/x"].astype(np.float64),
                     jax_results["fused/w"].astype(np.float64))
    np.testing.assert_allclose(got.reshape(FUSED["m"], FUSED["n"]), full,
                               rtol=1e-5, atol=1e-5)


def test_fused_ring_launches_p_block_gemms_per_rank():
    """Every rank runs P block GEMMs through matmul_tiled (the CPU path
    runs the plain version, so no kernel launch is counted)."""
    calls = []
    real = ops.matmul_tiled

    def spy(a, b):
        calls.append(tuple(a.shape))
        return real(a, b)

    ops.matmul_tiled = spy
    try:
        x = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(0))
        w = torch.randn(4, 8, 6, generator=torch.Generator().manual_seed(1))
        got = run_local(lambda c: impl.fused_matmul_rs(x[c.rank], w[c.rank],
                                                       c), 4, "cpu")
    finally:
        ops.matmul_tiled = real
    assert calls == [(4, 8)] * 16
    want = torch.einsum("pmk,pkn->mn", x, w).reshape(4, 4, 6)
    for r in range(4):
        torch.testing.assert_close(got[r], want[r], rtol=1e-5, atol=1e-5)


# ------------------- exact on integer-valued inputs --------------------- #
def _expected(op, xs, p, root=BROADCAST_ROOT):
    total = sum(x.astype(np.float64) for x in xs)
    rows = xs[0].shape[0] // p
    if op == "reduce":
        return {0: total}
    if op == "allreduce":
        return {r: total for r in range(p)}
    if op == "reduce_scatter":
        return {r: total[r * rows:(r + 1) * rows] for r in range(p)}
    if op == "allgather":
        return {r: np.concatenate(xs) for r in range(p)}
    if op == "broadcast":
        return {r: xs[root] for r in range(p)}
    return {r: np.concatenate([x[r * rows:(r + 1) * rows] for x in xs])
            for r in range(p)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [2, 3, 5, 8])
@pytest.mark.parametrize("op", list(ALGORITHMS))
def test_integer_inputs_exact_against_numpy(engine, op, p, dtype):
    rng = np.random.default_rng(p * 7)
    xs = [rng.integers(-8, 9, size=(2 * p * p, 5)).astype(np.float32)
          for _ in range(p)]
    pow2 = p & (p - 1) == 0
    for alg in ALGORITHMS[op]:
        if alg in ("tree", "doubling") and not pow2:
            continue
        got = _run_op(engine, op, alg, [torch.from_numpy(x).to(dtype)
                                        for x in xs], p=p, root=p - 1)
        for rank, want in _expected(op, xs, p, root=p - 1).items():
            assert got[rank].dtype == dtype
            assert np.array_equal(got[rank].float().numpy(), want), \
                (op, alg, p, rank)


# --------------------- ProcessGroupComm over gloo ----------------------- #
_GLOO_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.collectives import CollectiveEngine, ProcessGroupComm
    from repro_torch.collectives import shardmap_impl as impl

    rank, world, init, inputs, out = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    comm = ProcessGroupComm(device="cpu")
    assert (comm.rank, comm.size) == (rank, world)
    eng = CollectiveEngine(persist=False, device="cpu")
    data = np.load(inputs)
    res = {}
    for key in data.files:
        if key.startswith("x/"):
            continue
        op, alg, which = key.split("/")
        x = torch.from_numpy(data[f"x/{which}"][rank])
        fn = getattr(eng, op + "_inside")
        res[key] = (fn(x, comm, 1, alg) if op == "broadcast"
                    else fn(x, comm, alg)).numpy()
    res["fused"] = impl.fused_matmul_rs(
        torch.from_numpy(data["x/fx"][rank]),
        torch.from_numpy(data["x/fw"][rank]), comm).numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")

#: (op, algorithm, inputs): rounds of ppermutes on random floats, the
#: natives on integer-valued ones (gloo may add in another order)
GLOO_CASES = [("reduce", "chain", "rand"), ("reduce", "tree", "rand"),
              ("reduce", "autogen_pipelined", "rand"),
              ("allreduce", "ring", "rand"), ("allreduce", "two_phase", "rand"),
              ("reduce_scatter", "autogen", "rand"),
              ("allgather", "doubling", "rand"), ("allgather", "autogen", "rand"),
              ("broadcast", "autogen", "rand"), ("broadcast", "chain", "rand"),
              ("all_to_all", "halving", "rand"), ("all_to_all", "ring", "rand"),
              ("allreduce", "psum", "int"),
              ("reduce_scatter", "psum_scatter", "int"),
              ("allgather", "all_gather", "rand"),
              ("all_to_all", "lax", "rand")]


def test_process_group_comm_on_gloo_matches_local_comm(tmp_path, engine):
    world = 4
    rng = np.random.default_rng(11)
    inputs = {"x/rand": rng.normal(size=(world, 16, 3)).astype(np.float32),
              "x/int": rng.integers(-8, 9, size=(world, 16, 3)
                                    ).astype(np.float32),
              "x/fx": rng.normal(size=(world, 8, 6)).astype(np.float32),
              "x/fw": rng.normal(size=(world, 6, 5)).astype(np.float32)}
    for op, alg, which in GLOO_CASES:
        inputs[f"{op}/{alg}/{which}"] = np.zeros(1)
    np.savez(tmp_path / "inputs.npz", **inputs)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), str(world), init,
         str(tmp_path / "inputs.npz"), str(tmp_path / f"out{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]
    for op, alg, which in GLOO_CASES:
        xs = [torch.from_numpy(a) for a in inputs[f"x/{which}"]]
        local = _run_op(engine, op, alg, xs, p=world, root=1)
        for r in range(world):
            assert np.array_equal(outs[r][f"{op}/{alg}/{which}"],
                                  local[r].numpy()), (op, alg, r)
    fx = [torch.from_numpy(a) for a in inputs["x/fx"]]
    fw = [torch.from_numpy(a) for a in inputs["x/fw"]]
    local = run_local(lambda c: impl.fused_matmul_rs(fx[c.rank], fw[c.rank],
                                                   c), world, "cpu")
    for r in range(world):
        assert np.array_equal(outs[r]["fused"], local[r].numpy())


# ------------------------- the communicators ---------------------------- #
def test_ppermute_gives_zeros_to_ranks_that_receive_nothing():
    xs = [torch.full((3,), float(r + 1)) for r in range(4)]
    got = run_local(lambda c: c.ppermute(xs[c.rank], [(0, 2), (3, 1),
                                                      (2, 3)]), 4, "cpu")
    assert torch.equal(got[0], torch.zeros(3))
    assert torch.equal(got[1], xs[3])
    assert torch.equal(got[2], xs[0])
    assert torch.equal(got[3], xs[2])
    same = run_local(lambda c: c.ppermute(xs[c.rank], [(1, 1)]), 4, "cpu")
    assert torch.equal(same[1], xs[1]) and same[1] is not xs[1]


def test_ppermute_refuses_rounds_that_are_not_disjoint():
    with pytest.raises(ValueError, match="disjoint"):
        run_local(lambda c: c.ppermute(torch.zeros(2), [(0, 1), (2, 1)]),
                  3, "cpu")
    with pytest.raises(ValueError, match="outside"):
        run_local(lambda c: c.ppermute(torch.zeros(2), [(0, 5)]), 3, "cpu")


def test_an_error_in_one_rank_releases_the_others():
    def fn(c):
        if c.rank == 2:
            raise KeyError("rank 2 fails")
        return c.ppermute(torch.zeros(2), [(0, 1)])

    with pytest.raises(KeyError, match="rank 2 fails"):
        run_local(fn, 4, "cpu", timeout=60)


def test_local_comm_refuses_tensors_on_another_device():
    with pytest.raises(ValueError, match="tensor on meta"):
        run_local(lambda c: c.psum(torch.zeros(2, device="meta")), 2, "cpu")


def test_comms_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU default is what is tested here")
    with pytest.raises(RuntimeError, match="no GPU"):
        run_local(lambda c: c.rank, 2)
    with pytest.raises(RuntimeError, match="no GPU"):
        ProcessGroupComm()


def test_local_ranks_under_thread_stress():
    """More rank threads than cores and a tiny switch interval: rounds
    stay in step (exact ring sums on every rank) and the shared engine's
    counters lose no update (one select per rank per call)."""
    p, calls = 16, 6
    eng = CollectiveEngine(persist=False, device="cpu")
    xs = [torch.full((p * 4,), float(r)) for r in range(p)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = run_local(lambda c: [eng.allreduce_inside(xs[c.rank], c,
                                                         "auto")
                                    for _ in range(calls)], p, "cpu",
                         timeout=120)
    finally:
        sys.setswitchinterval(old)
    total = float(sum(range(p)))
    for per_rank in outs:
        for o in per_rank:
            assert torch.equal(o, torch.full((p * 4,), total))
    assert eng.stats["hits"] + eng.stats["misses"] == p * calls
    assert eng.stats["misses"] == 1
