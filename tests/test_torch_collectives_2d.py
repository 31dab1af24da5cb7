"""The port's grid of ranks, the paper's 2D algorithms (Sec. 7) and the
engine's multi-axis ops against the JAX package's.

* ``xy_reduce_2d``, ``snake_reduce_2d``, ``broadcast_2d`` and both 2D
  AllReduces, and ``allreduce_multi``, ``reduce_scatter_multi``,
  ``allgather_multi`` and ``all_to_all_multi`` under every plan shape the
  reference offers on the grid, its natives, a 1D backend and ``auto``:
  on ``run_local_grid`` CPU ranks as (2, 4) over ("pod", "data") and
  ("data", "pod"), and as (2, 2, 2) over ("pod", "data") and ("pod",
  "data", "model"), bitwise equal on every rank to the JAX engine under
  ``shard_map`` on 8 virtual CPU devices, in float32 and bfloat16
  (normal values; odd lengths).  The JAX side runs once per file in a
  subprocess, one jitted program per (grid, axes, op, size), and hands
  its results back as ``.npz``.  ("data", "pod") on the (2, 4) grid is
  held to the reference on a (4, 2) mesh over ("data", "pod") with the
  ranks relabelled: the reference's ppermute over a folded tuple numbers
  devices in mesh order while its ``_axis_index`` and natives number
  them in the tuple's order, so on a mesh whose order is not the
  tuple's its ppermute algorithms over the folded axis do not compute
  the collective (ROADMAP C14); the port numbers both in the tuple's
  order.
* Integer-valued inputs, exact against numpy.
* A rank that raises releases every row, column and folded subset.
* ``ProcessGroupGrid`` on 4 gloo processes as a 2 x 2 grid: the same
  bits as ``run_local_grid``.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import (CollectiveEngine, planner,
                                     run_local_grid)
from repro_torch.collectives import shardmap_impl as impl

ROOT = Path(__file__).resolve().parents[1]

GRIDS = {"24": ((2, 4), ("pod", "data")),
         "222": ((2, 2, 2), ("pod", "data", "model"))}
#: the reference's mesh for each (grid, axes), and which rank of the
#: port's grid each of its devices stands for
JAX_MESH = {("24", ("data", "pod")): (
    ((4, 2), ("data", "pod")), [4 * p + d for d in range(4)
                                for p in range(2)])}
#: (grid, axes the op runs over)
SUBSETS = (("24", ("pod", "data")), ("24", ("data", "pod")),
           ("222", ("pod", "data")), ("222", ("pod", "data", "model")))
OPS = ("allreduce", "reduce_scatter", "allgather", "all_to_all")
NATIVE = {"allreduce": "psum", "reduce_scatter": "psum_scatter",
          "allgather": "all_gather", "all_to_all": "lax"}
#: per-rank shapes: "small" (every algorithm; odd trailing lengths) and
#: "large" (auto only: ~160 KB float32, where auto leaves the latency
#: regime); reduce_scatter / all_to_all rows divide by 4 and 8
SHAPES = {"allreduce": {"small": (13,), "large": (40001,)},
          "reduce_scatter": {"small": (24, 5), "large": (10000, 4)},
          "allgather": {"small": (3, 5), "large": (1250, 4)},
          "all_to_all": {"small": (24, 5), "large": (10000, 4)}}
#: the 2D functions, on every two-axis subset (root / patterns valid on
#: both orders of the (2, 4) grid)
FNS_2D = {
    "xy_reduce_chain_chain": ("xy_reduce_2d", ("chain", "chain")),
    "xy_reduce_tree_two_phase": ("xy_reduce_2d", ("tree", "two_phase")),
    "xy_reduce_two_phase_star": ("xy_reduce_2d", ("two_phase", "star")),
    "snake_reduce": ("snake_reduce_2d", None),
    "broadcast_root_1_1": ("broadcast_2d", (1, 1)),
    "xy_allreduce": ("xy_allreduce_2d", ("chain", "chain")),
    "snake_allreduce": ("snake_allreduce_2d", None),
}


def algorithms(op, n_axes):
    """What the reference offers for ``op`` over ``n_axes`` effective
    axes: its plan shapes (the 2D ones on two axes only; ``latency`` not
    for reduce_scatter), ``auto``, the native and a 1D backend."""
    if op == "allreduce":
        shapes = [s for s in planner.ALLREDUCE_SHAPES
                  if n_axes == 2 or not s.startswith("2d_")]
        return ["auto", "psum", "ring"] + shapes
    if op == "all_to_all":
        return (["auto", "lax", "ring", "halving"]
                + list(planner.ALL_TO_ALL_SHAPES))
    return (["auto", NATIVE[op]]
            + [s for s in planner.SHARDED_SHAPES
               if op == "allgather" or s != "latency"])


def _sid(subset):
    return f"{subset[0]}-{'.'.join(subset[1])}"


MULTI_CASES = [(subset, op, alg) for subset in SUBSETS for op in OPS
               for alg in algorithms(op, len(subset[1]))]
CASES_2D = [(subset, name) for subset in SUBSETS if len(subset[1]) == 2
            for name in FNS_2D]


def _inputs():
    """Per (op, size): float32 normal [8, ...] and its bf16 rounding
    (as uint16 bits), the same for every subset."""
    rng = np.random.default_rng(2024)
    out = {}
    for op, sizes in SHAPES.items():
        for size, shape in sizes.items():
            x = rng.normal(size=(8,) + shape).astype(np.float32)
            out[f"{op}/{size}/f32"] = x
            out[f"{op}/{size}/bf16"] = (torch.from_numpy(x)
                                        .to(torch.bfloat16)
                                        .view(torch.int16).numpy()
                                        .view(np.uint16))
    x = rng.normal(size=(8, 13)).astype(np.float32)
    out["2d/f32"] = x
    out["2d/bf16"] = (torch.from_numpy(x).to(torch.bfloat16)
                      .view(torch.int16).numpy().view(np.uint16))
    return out


_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.collectives.engine import CollectiveEngine
    from repro.collectives import shardmap_impl as impl

    jobs, fns_2d = eval(sys.argv[3])
    data = dict(np.load(sys.argv[1]))
    eng = CollectiveEngine(persist=False)
    out = {}

    def arrays(key):
        return (data[key + "/f32"],
                data[key + "/bf16"].view(jnp.bfloat16))

    def run(mesh_of, fns, key):
        (shape, names), ranks = mesh_of
        mesh = jax.make_mesh(shape, names)
        spec = P(names)

        def body(a, b):
            return tuple(f(v)[None] for f in fns for v in (a[0], b[0]))

        sm = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec, check_rep=False)
        res = jax.jit(sm)(*(a[ranks] for a in arrays(key)))
        back = np.argsort(ranks)        # device of each port rank
        return [np.asarray(r)[back] for r in res]

    for grid, axes, mesh_of, op, size, algs in jobs:
        fn = getattr(eng, op + "_multi")
        fns = [lambda v, alg=alg: fn(v, axes, alg) for alg in algs]
        res = run(mesh_of, fns, f"{op}/{size}")
        for i, alg in enumerate(algs):
            for j, dt in enumerate(("f32", "bf16")):
                r = res[2 * i + j]
                out[f"{grid}|{'.'.join(axes)}|{op}|{alg}|{size}|{dt}"] = (
                    r if dt == "f32" else r.view(np.uint16))
    pairs = {(g, a): m for g, a, m, *_ in jobs if len(a) == 2}
    for (grid, axes), mesh_of in pairs.items():
        names = sorted(fns_2d)
        fns = []
        for name in names:
            f, arg = fns_2d[name]
            f = getattr(impl, f)
            fns.append((lambda v, f=f: f(v, axes)) if arg is None
                       else (lambda v, f=f, arg=arg: f(v, axes, arg)))
        res = run(mesh_of, fns, "2d")
        for i, name in enumerate(names):
            for j, dt in enumerate(("f32", "bf16")):
                r = res[2 * i + j]
                out[f"{grid}|{'.'.join(axes)}|2d|{name}|{dt}"] = (
                    r if dt == "f32" else r.view(np.uint16))
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("jax_collectives_2d")
    np.savez(tmp / "inputs.npz", **inputs)
    jobs = [(g, axes,
             JAX_MESH.get((g, axes), (GRIDS[g], list(range(8)))), op, size,
             algorithms(op, len(axes)) if size == "small" else ["auto"])
            for g, axes in SUBSETS for op in OPS for size in SHAPES[op]]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", REPRO_CACHE_DIR=str(tmp / "cache"),
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "results.npz"), repr((jobs, FNS_2D))],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "results.npz"))


@pytest.fixture(scope="module")
def engine():
    return CollectiveEngine(persist=False, device="cpu")


def _torch_inputs(inputs, key):
    """The float32 and bf16 inputs of ``key`` as per-rank tensors."""
    f32 = [torch.from_numpy(a) for a in inputs[key + "/f32"]]
    bf16 = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            for a in inputs[key + "/bf16"]]
    return {"f32": f32, "bf16": bf16}


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _run_grid(grid, fn):
    shape, names = GRIDS[grid]
    return run_local_grid(fn, shape, names, "cpu", timeout=120)


def _assert_bitwise(got, want, label):
    for rank, g in enumerate(got):
        g = _bits(g)
        assert g.dtype == want.dtype and g.shape == want[rank].shape, \
            (label, rank, g.dtype, g.shape, want[rank].shape)
        assert np.array_equal(g, want[rank]), (label, rank)


# -------------------- bitwise parity with the JAX engine ----------------- #
@pytest.mark.parametrize("subset,name", CASES_2D,
                         ids=[f"{_sid(s)}-{n}" for s, n in CASES_2D])
def test_2d_algorithms_bitwise_equal_to_jax(jax_results, inputs, subset,
                                            name):
    grid, axes = subset
    f, arg = FNS_2D[name]
    f = getattr(impl, f)
    for dt, xs in _torch_inputs(inputs, "2d").items():
        if arg is None:
            got = _run_grid(grid, lambda g: f(xs[g.rank], g, axes))
        else:
            got = _run_grid(grid, lambda g: f(xs[g.rank], g, axes, arg))
        _assert_bitwise(got, jax_results[
            f"{grid}|{'.'.join(axes)}|2d|{name}|{dt}"], (name, dt))


@pytest.mark.parametrize("subset,op,alg", MULTI_CASES,
                         ids=[f"{_sid(s)}-{o}-{a}" for s, o, a in MULTI_CASES])
def test_multi_ops_bitwise_equal_to_jax(jax_results, inputs, engine, subset,
                                        op, alg):
    grid, axes = subset
    fn = getattr(engine, op + "_multi")
    for size in (["small", "large"] if alg == "auto" else ["small"]):
        for dt, xs in _torch_inputs(inputs, f"{op}/{size}").items():
            got = _run_grid(grid, lambda g: fn(xs[g.rank], g, axes, alg))
            _assert_bitwise(got, jax_results[
                f"{grid}|{'.'.join(axes)}|{op}|{alg}|{size}|{dt}"],
                (op, alg, size, dt))


# ------------------- exact on integer-valued inputs --------------------- #
def _expected(op, xs, axes_members, rank):
    """What ``rank`` must hold: ``axes_members`` are the global ranks of
    its sub-group in the sub-group's rank order."""
    group = [xs[m] for m in axes_members]
    p = len(group)
    me = axes_members.index(rank)
    if op == "allreduce":
        return sum(x.astype(np.float64) for x in group)
    if op == "reduce_scatter":
        total = sum(x.astype(np.float64) for x in group)
        rows = total.shape[0] // p
        return total[me * rows:(me + 1) * rows]
    if op == "allgather":
        return np.concatenate(group)
    rows = group[0].shape[0] // p
    return np.concatenate([x[me * rows:(me + 1) * rows] for x in group])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("subset", SUBSETS, ids=_sid)
@pytest.mark.parametrize("op", OPS)
def test_integer_inputs_exact_against_numpy(engine, op, subset, dtype):
    grid, axes = subset
    rng = np.random.default_rng(len(axes) * 7 + len(op))
    shape = SHAPES[op]["small"]
    xs = [rng.integers(-8, 9, size=shape).astype(np.float32)
          for _ in range(8)]
    fn = getattr(engine, op + "_multi")
    for alg in algorithms(op, len(axes)):
        got = _run_grid(grid, lambda g: (
            fn(torch.from_numpy(xs[g.rank]).to(dtype), g, axes, alg),
            g.members(axes)))
        for rank, (out, members) in enumerate(got):
            assert out.dtype == dtype
            want = _expected(op, xs, members, rank)
            assert np.array_equal(out.float().numpy(), want), \
                (op, alg, subset, rank)


# ----------------------------- the grid ---------------------------------- #
def test_grid_sub_comms_number_ranks_in_the_order_given():
    def fn(g):
        return {axes: (g.sub(axes).rank, g.sub(axes).size,
                       g.sub(axes).axis, g.members(axes))
                for axes in ("data", ("pod", "data"), ("data", "pod"))}

    got = _run_grid("24", fn)
    for rank, subs in enumerate(got):
        pod, data = divmod(rank, 4)
        assert subs["data"] == (data, 4, "data",
                                [4 * pod + d for d in range(4)])
        assert subs[("pod", "data")][:3] == (rank, 8, ("pod", "data"))
        assert subs[("data", "pod")] == (
            2 * data + pod, 8, ("data", "pod"),
            [4 * p + d for d in range(4) for p in range(2)])


def test_grid_refuses_bad_axes():
    with pytest.raises(ValueError, match="no axis"):
        _run_grid("24", lambda g: g.sub("model"))
    with pytest.raises(ValueError, match="repeated axis"):
        _run_grid("24", lambda g: g.sub(("pod", "pod")))
    with pytest.raises(ValueError, match="repeated axis name"):
        run_local_grid(lambda g: g.rank, (2, 2), ("a", "a"), "cpu")


def test_an_error_in_one_rank_releases_the_whole_grid():
    """Rank 5 fails; its row waits in a row barrier, the other row gets
    through its own and then waits in the column groups, made after the
    failure: every barrier is released, well inside the timeout."""
    def fn(g):
        if g.rank == 5:
            raise KeyError("rank 5 fails")
        x = g.sub("data").psum(torch.ones(3))
        return g.sub("pod").psum(x)

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 5 fails"):
        run_local_grid(fn, (2, 4), ("pod", "data"), "cpu", timeout=60)
    assert time.perf_counter() - t0 < 20


def test_grid_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU default is what is tested here")
    with pytest.raises(RuntimeError, match="no GPU"):
        run_local_grid(lambda g: g.rank, (2, 2), ("a", "b"))


# --------------------- ProcessGroupGrid over gloo ----------------------- #
_GLOO_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.collectives import CollectiveEngine, ProcessGroupGrid

    rank, world, init, inputs, out = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    grid = ProcessGroupGrid((2, 2), ("pod", "data"), device="cpu")
    assert grid.rank == rank and grid.coords == divmod(rank, 2)
    eng = CollectiveEngine(persist=False, device="cpu")
    data = np.load(inputs)
    cases = eval(sys.argv[6])
    res = {}
    for op, axes, alg, which in cases:
        x = torch.from_numpy(data[f"x/{which}"][rank])
        fn = getattr(eng, op + "_multi")
        res[f"{op}/{'.'.join(axes)}/{alg}/{which}"] = fn(
            x, grid, axes, alg).numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
""")

#: (op, axes, algorithm, inputs): the 2D algorithms and hierarchical
#: (ppermute rounds and a 2-rank native sum) on random floats; flat and
#: the natives over the folded axes in both orders (``("data", "pod")``
#: renumbers the gloo group's ranks) on integer-valued ones (gloo may
#: add in another order)
GLOO_CASES = [("allreduce", ("pod", "data"), alg, which)
              for alg in ("2d_xy", "2d_snake", "hierarchical", "flat")
              for which in ("rand", "int")
              if alg != "flat" or which == "int"] + [
    ("allreduce", ("data", "pod"), "2d_snake", "rand"),
    ("reduce_scatter", ("data", "pod"), "psum_scatter", "int"),
    ("reduce_scatter", ("data", "pod"), "cascade", "rand"),
    ("allgather", ("data", "pod"), "all_gather", "rand"),
    ("allgather", ("pod", "data"), "cascade", "rand"),
    ("all_to_all", ("data", "pod"), "lax", "rand"),
    ("all_to_all", ("pod", "data"), "hierarchical", "rand")]


def test_process_group_grid_on_gloo_matches_local_grid(tmp_path, engine):
    world = 4
    rng = np.random.default_rng(5)
    inputs = {"x/rand": rng.normal(size=(world, 1000)).astype(np.float32),
              "x/int": rng.integers(-8, 9, size=(world, 1000)
                                    ).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", **inputs)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), str(world), init,
         str(tmp_path / "inputs.npz"), str(tmp_path / f"out{r}.npz"),
         repr(GLOO_CASES)],
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
    for op, axes, alg, which in GLOO_CASES:
        xs = [torch.from_numpy(a) for a in inputs[f"x/{which}"]]
        fn = getattr(engine, op + "_multi")
        local = run_local_grid(lambda g: fn(xs[g.rank], g, axes, alg),
                               (2, 2), ("pod", "data"), "cpu")
        for r in range(world):
            assert np.array_equal(
                outs[r][f"{op}/{'.'.join(axes)}/{alg}/{which}"],
                local[r].numpy()), (op, axes, alg, which, r)
