"""The port's topology planner (``repro_torch.collectives.planner``) and
the engine's ``plan_multi`` against the reference's.  Plans need no
devices, so both engines run in this process.  Every comparison is
``==``: the planner is the same arithmetic over bit-identical prices, so
shapes, ``describe()`` strings, chunk counts, predictions, cost terms
and lower bounds must match exactly over

* ops {allreduce, reduce_scatter, allgather, all_to_all} x axis sizes
  {(2, 2), (2, 4), (4, 2), (2, 16), (2, 2, 2)} x bytes 2^10 ... 2^26;
* every forced shape the reference offers at those sizes;
* non-uniform fabric topologies (slow pod links) and WSE2;
* the plans section of the persisted file and its hit/miss counters;
* the Lemma 7.2 check that refuses a price below the lower bound.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest
import torch

import repro.collectives.api as j_api
import repro.collectives.engine as j_engine
import repro.collectives.planner as j_planner
import repro.core.model as j_model
import repro_torch.collectives.api as t_api
import repro_torch.collectives.engine as t_engine
import repro_torch.collectives.planner as t_planner
import repro_torch.core.model as t_model
from repro_torch.collectives import run_local_grid

OPS = ("allreduce", "reduce_scatter", "allgather", "all_to_all")
SIZES = ((2, 2), (2, 4), (4, 2), (2, 16), (2, 2, 2))
NBYTES = tuple(1 << k for k in range(10, 27))
AXES = ("pod", "data", "model")
SHAPES = {"allreduce": j_planner.ALLREDUCE_SHAPES,
          "reduce_scatter": j_planner.SHARDED_SHAPES,
          "allgather": j_planner.SHARDED_SHAPES,
          "all_to_all": j_planner.ALL_TO_ALL_SHAPES}


@pytest.fixture(autouse=True)
def _private_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "torch"))


def _engines(spec=None, fabric=None, persist=False):
    if spec is not None:
        jf, tf = (j_model.parse_fabric_topology(spec),
                  t_model.parse_fabric_topology(spec))
    elif fabric is not None:
        jf = fabric
        tf = t_model.Fabric(**dataclasses.asdict(fabric))
    else:
        jf, tf = j_model.TPU_V5E_AXIS, t_model.TPU_V5E_AXIS
    return (t_engine.CollectiveEngine(tf, persist=persist, device="cpu"),
            j_engine.CollectiveEngine(jf, persist=persist))


def _plan_fields(plan):
    return (plan.op, plan.axes, plan.axis_sizes, plan.nbytes, plan.shape,
            tuple((s.kind, s.axes, s.algorithm, s.nbytes)
                  for s in plan.steps),
            plan.describe(), plan.n_chunks, plan.predicted,
            plan.predictions, list(plan.predictions), plan.cost_terms,
            plan.lower_bound)


def _same_plan(tp, jp):
    assert _plan_fields(tp) == _plan_fields(jp), (tp.describe(),
                                                  jp.describe())
    for shape in jp.cost_terms:
        assert list(tp.cost_terms[shape]) == list(jp.cost_terms[shape])


def _grid_id(sizes):
    return "x".join(map(str, sizes))


@pytest.mark.parametrize("sizes", SIZES, ids=_grid_id)
@pytest.mark.parametrize("op", OPS)
def test_plan_multi_equals_the_reference(op, sizes):
    teng, jeng = _engines()
    axes = AXES[:len(sizes)]
    for nbytes in NBYTES:
        _same_plan(teng.plan_multi(op, axes, sizes, nbytes),
                   jeng.plan_multi(op, axes, sizes, nbytes))
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("sizes", [(2, 4), (2, 2, 2)], ids=_grid_id)
@pytest.mark.parametrize("op", OPS)
def test_forced_shapes_equal_the_reference(op, sizes):
    teng, jeng = _engines()
    axes = AXES[:len(sizes)]
    for nbytes in (1 << 10, 1 << 18, 1 << 24):
        offered = jeng.plan_multi(op, axes, sizes, nbytes).predictions
        teng.plan_multi(op, axes, sizes, nbytes)
        for shape in SHAPES[op]:
            if shape not in offered:
                for eng in (teng, jeng):
                    with pytest.raises(ValueError,
                                       match="not a candidate"):
                        eng.plan_multi(op, axes, sizes, nbytes,
                                       shape=shape)
                continue
            tp = teng.plan_multi(op, axes, sizes, nbytes, shape=shape)
            _same_plan(tp, jeng.plan_multi(op, axes, sizes, nbytes,
                                           shape=shape))
            assert tp.shape == shape
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("spec", ["pod=slow", "pod=dcn,data=0.5",
                                  "data=slow"])
@pytest.mark.parametrize("op", OPS)
def test_non_uniform_topologies_equal_the_reference(op, spec):
    """Per-axis fabrics price each phase and enter the key (``|f=``)."""
    teng, jeng = _engines(spec=spec)
    for sizes in ((2, 4), (2, 16), (2, 2, 2)):
        axes = AXES[:len(sizes)]
        for nbytes in (1 << 12, 1 << 20, 1 << 26):
            _same_plan(teng.plan_multi(op, axes, sizes, nbytes),
                       jeng.plan_multi(op, axes, sizes, nbytes))
            # the same sizes bound to names without an override
            _same_plan(teng.plan_multi(op, ("x", "y", "z")[:len(sizes)],
                                       sizes, nbytes),
                       jeng.plan_multi(op, ("x", "y", "z")[:len(sizes)],
                                       sizes, nbytes))
    assert teng.stats == jeng.stats
    assert sorted(teng._plans) == sorted(jeng._plans)


def test_wse2_plans_equal_the_reference():
    teng, jeng = _engines(fabric=j_model.WSE2)
    for sizes in ((4, 4), (8, 8), (2, 16)):
        for nbytes in (64 * 512, 4096 * 512):
            _same_plan(teng.plan_multi("allreduce", ("y", "x"), sizes,
                                       nbytes),
                       jeng.plan_multi("allreduce", ("y", "x"), sizes,
                                       nbytes))


@pytest.mark.parametrize("op", OPS)
def test_plan_collective_records_equal_the_reference(op):
    """The positional record (what the engine persists) and its binding,
    called on the planner directly with each engine's ``select``."""
    teng, jeng = _engines()
    for sizes in ((2, 4), (2, 2, 2), (1, 8), (1, 1)):
        for nbytes in (1 << 11, 1 << 23):
            args = (op, sizes, nbytes)
            trec = t_planner.plan_collective(
                *args, t_model.TPU_V5E_AXIS, 512, teng.select)
            jrec = j_planner.plan_collective(
                *args, j_model.TPU_V5E_AXIS, 512, jeng.select)
            assert json.dumps(trec) == json.dumps(jrec)
            axes = AXES[:len(sizes)]
            _same_plan(t_planner.bind_plan(trec, op, axes),
                       j_planner.bind_plan(jrec, op, axes))
            assert t_planner.lower_bound_multi(
                op, sizes, nbytes, t_model.TPU_V5E_AXIS, 512) == \
                j_planner.lower_bound_multi(op, sizes, nbytes,
                                            j_model.TPU_V5E_AXIS, 512)
    assert t_planner.ALLREDUCE_SHAPES == j_planner.ALLREDUCE_SHAPES
    assert t_planner.SHARDED_SHAPES == j_planner.SHARDED_SHAPES
    assert t_planner.ALL_TO_ALL_SHAPES == j_planner.ALL_TO_ALL_SHAPES
    assert (t_planner.PIPELINE_CHUNK_CANDIDATES
            == j_planner.PIPELINE_CHUNK_CANDIDATES)


@pytest.mark.parametrize("op", OPS)
def test_lemma_7_2_check_raises_as_the_reference(op):
    """A candidate priced below the overlap-aware lower bound is a model
    inconsistency: both planners refuse it with the same message."""
    def cheap(op_, nbytes, p, topo=None, fabric=None):
        return SimpleNamespace(algorithm="ring", predicted=0.0)

    msgs = []
    for pl, fab in ((t_planner, t_model.TPU_V5E_AXIS),
                    (j_planner, j_model.TPU_V5E_AXIS)):
        with pytest.raises(RuntimeError, match="model inconsistency") as e:
            pl.plan_collective(op, (2, 4), 1 << 20, fab, 512, cheap)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_plans_persist_round_trip_and_counters(tmp_path):
    """The ``plans`` section is written beside the decisions, in the
    reference's layout, and a fresh engine serves it as hits."""
    teng, jeng = _engines(persist=True)
    for eng in (teng, jeng):
        eng.plan_multi("allreduce", ("pod", "data"), (2, 8), 1 << 20)
        eng.plan_multi("allreduce", ("pod", "data"), (2, 8), 1 << 20)
        eng.plan_multi("all_to_all", ("pod", "data"), (2, 4), 1 << 16,
                       shape="sequential")
        eng.plan_multi("allreduce", ("pod", "data"), (4, 4), 1 << 20)
        eng.flush()
    assert teng.stats == jeng.stats
    assert teng.stats["plan_misses"] == 3 and teng.stats["plan_hits"] == 1
    (name,) = [f for f in (tmp_path / "torch").iterdir()
               if f.name.startswith("engine_decisions")]
    tp = json.loads(name.read_text())
    jp = json.loads((tmp_path / "jax" / name.name).read_text())
    assert tp == jp
    assert sorted(tp["plans"]) == [
        "all_to_all|t=2x4|B=65536|shape=sequential",
        "allreduce|t=2x8|B=1048576", "allreduce|t=4x4|B=1048576"]

    again = t_engine.CollectiveEngine(persist=True, device="cpu")
    plan = again.plan_multi("allreduce", ("x", "y"), (2, 8), 1 << 20)
    assert again.stats["plan_hits"] == 1 and again.stats["plan_misses"] == 0
    assert again.stats["persisted_loads"] == len(tp["decisions"]) + 3
    assert plan.steps[0].axes[0] in ("x", "y")      # names rebind
    _same_plan(plan, jeng.plan_multi("allreduce", ("x", "y"), (2, 8),
                                     1 << 20))
    again.clear_cache()          # forgets, then rereads the file
    again.plan_multi("allreduce", ("x", "y"), (2, 8), 1 << 20)
    assert again.stats["plan_hits"] == 2 and again.stats["plan_misses"] == 0


def test_api_plan_collective_reads_the_grid():
    """``api.plan_collective`` takes the axis sizes from a grid, as the
    reference takes them from a mesh."""
    jmesh = SimpleNamespace(shape={"pod": 2, "data": 4})
    want = j_api.get_engine().plan_multi("allreduce", ("pod", "data"),
                                         (2, 4), 1 << 20)
    assert j_api.plan_collective("allreduce", jmesh, ("pod", "data"),
                                 1 << 20) == want
    got = run_local_grid(
        lambda g: t_api.plan_collective("allreduce", g, ("pod", "data"),
                                        1 << 20),
        (2, 4), ("pod", "data"), "cpu")
    for plan in got:
        _same_plan(plan, want)


def test_local_grid_ranks_share_one_plan_miss():
    """Under run_local_grid the ranks share the engine: one multi call
    is 1 plan miss and P-1 plan hits."""
    eng = t_engine.CollectiveEngine(persist=False, device="cpu")
    run_local_grid(lambda g: eng.allreduce_multi(
        torch.ones(40), g, ("pod", "data"), "hierarchical"),
        (2, 4), ("pod", "data"), "cpu")
    assert eng.stats["plan_misses"] == 1 and eng.stats["plan_hits"] == 7
