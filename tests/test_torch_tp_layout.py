"""The execution layout over "model" (``sharding.rules.shard_params``)
and the grids of ``launch/mesh.py``:

* every config, reduced (real tensors) at m 2 and 4: ``unshard_params``
  of the ranks' trees (threads) gives the whole tree exactly; at full
  width (meta tensors) a rank holds 1 / m
  of every leaf the layout cuts (E / m experts, H / m heads, d_ff / m,
  di / m) and the other leaves whole;
* where the layout leaves the spec's contiguous block
  (``spec_for_param``), shown against it: ``in_proj``'s channels of x and
  of z, MQA's whole kv projections; an odd vocabulary, which the spec
  moves onto d_model, padded and kept vocab-parallel;
* the refusals name the config and m (heads that do not divide m are
  padded: ``test_torch_tp_padding.py``); the one rule (``tp_degree``)
  reads a tree off its embedding; caches, page pools and train state follow
  the layout; ``params_from_jax(..., grid=)`` round-trips exactly;
* the four grids equal the reference's meshes (``jax.make_mesh``
  replaced, so no 256-device mesh is built).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro.models import transformer as jtf
from repro_torch.collectives import run_local_grid
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh
from repro_torch.models import init_cache, init_params
from repro_torch.models.paged import init_pages
from repro_torch.models.transformer import shard_decode_cache
from repro_torch.sharding import rules
from repro_torch.train.state import (init_train_state, rank_state_bytes,
                                     shard_train_state)
from repro_torch.tree import tree_leaves
from torch_util import configs, jax_params_numpy

ARCHS = list_archs()


def _reduced(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_join_back_to_the_whole_tree_exactly(arch, m):
    cfg = _reduced(arch)
    params = init_params(cfg, seed=3, device="cpu")

    def fn(grid):
        local = rules.shard_params(params, cfg, grid)
        assert rules.tp_degree(local, cfg) == m
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (m,), ("model",), "cpu"):
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_rank_holds_one_mth_of_each_cut_leaf(arch, m):
    cfg = get_config(arch)
    whole = init_params(cfg, device="meta")
    local = rules.shard_for_rank(whole, cfg, m, 1)
    flags = rules.model_sharded_leaves(local, cfg)
    # the embedding and the head over the padded vocabulary
    vp, d = rules.padded_vocab(cfg, m), cfg.d_model
    whole = dict(whole, embed=whole["embed"].new_empty(vp, d),
                 head=whole["head"].new_empty(d, vp))
    assert any(flags)
    for w, x, cut in zip(tree_leaves(whole), tree_leaves(local), flags):
        assert x.numel() * (m if cut else 1) == w.numel()
    cut_bytes = sum(w.numel() * w.element_size() for w, f in
                    zip(tree_leaves(whole), flags) if f)
    all_bytes = sum(w.numel() * w.element_size() for w in tree_leaves(whole))
    got = rank_state_bytes(cfg, m)
    assert got["params"] == all_bytes - cut_bytes + cut_bytes // m
    # float32 moments, two a leaf, in the leaf's layout
    assert got["opt"] == 2 * sum(x.numel() * 4 for x in tree_leaves(local))


@pytest.mark.parametrize("arch", ["minicpm-2b", "falcon-mamba-7b"])
def test_unshard_params_on_a_data_model_grid_is_exact(arch):
    cfg = _reduced(arch)
    params = init_params(cfg, seed=5, device="cpu")

    def fn(grid):
        local = rules.shard_params(params, cfg, grid)
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (2, 2), ("data", "model"), "cpu"):
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)


def _spec_block(x, spec, m, r):
    """Rank r's block of ``x`` under a spec over a model axis of m."""
    dims = [i for i, a in enumerate(spec) if a == "model"]
    assert len(dims) == 1
    n = x.shape[dims[0]] // m
    return x.narrow(dims[0], r * n, n)


def _policy(m):
    return rules.ShardingPolicy(fsdp=False, axis_sizes=(("data", 1),
                                                        ("model", m)))


def test_in_proj_takes_the_same_channels_of_x_and_z():
    cfg = get_config("falcon-mamba-7b")
    di, m = cfg.d_inner, 2
    spec = rules.spec_for_param(("layers", 0, "in_proj"),
                                (cfg.num_layers, cfg.d_model, 2 * di),
                                _policy(m))[1:]
    assert spec == (None, "model")
    w = torch.arange(2 * di, dtype=torch.float32).expand(4, 2 * di)
    for r in range(m):
        got = rules.shard_for_rank({"embed": torch.zeros(cfg.vocab_size, 1),
                                    "in_proj": w}, dataclasses.replace(
                                        cfg, d_model=1), m, r)["in_proj"]
        cols = got[0].long().tolist()
        half = di // m
        assert cols == (list(range(r * half, (r + 1) * half))
                        + list(range(di + r * half, di + (r + 1) * half)))
        # the spec's block: rank 0 all of x, rank 1 all of z
        block = _spec_block(w, spec, m, r)[0].long().tolist()
        assert block == list(range(r * di, (r + 1) * di))


def test_mqa_keeps_the_kv_projections_whole():
    cfg = get_config("recurrentgemma-9b")
    m, hd = 4, cfg.resolved_head_dim
    spec = rules.spec_for_param(("cycles", "b2", 0, "wk"),
                                (1, cfg.d_model, cfg.num_kv_heads * hd),
                                _policy(m))[1:]
    # the spec cuts the one kv head's 256 columns into quarters
    assert spec == (None, "model")
    layout = rules.exec_layout(cfg, m)
    assert layout["wk"] is None and layout["wv"] is None
    assert layout["wq"] == 1 and layout["wo"] == 0
    whole = init_params(cfg, device="meta")
    lp = rules.shard_for_rank(whole, cfg, m, 3)["cycles"]["b2"][0]
    assert lp["wk"].shape == (cfg.d_model, hd)
    assert lp["wq"].shape == (cfg.d_model, cfg.num_heads // m * hd)


@pytest.mark.parametrize("arch", ["minicpm-2b", "whisper-medium"])
def test_odd_vocabulary_cuts_d_model_as_the_spec_does(arch):
    """The spec moves "model" onto d_model, as the reference's does; the
    execution pads the vocabulary instead and keeps it vocab-parallel."""
    cfg = get_config(arch)
    m = 2
    assert cfg.vocab_size % m
    v, d = cfg.vocab_size, cfg.d_model
    assert rules.spec_for_param(("embed",), (v, d), _policy(m)) == (None,
                                                                  "model")
    assert rules.spec_for_param(("head",), (d, v), _policy(m)) == ("model",
                                                                 None)
    layout = rules.exec_layout(cfg, m)
    assert (layout["embed"], layout["head"]) == (0, 1)
    even = rules.exec_layout(get_config("yi-34b"), m)
    assert (even["embed"], even["head"]) == (0, 1)
    n = rules.padded_vocab(cfg, m) // m
    assert n * m == v + 1
    whole = init_params(cfg, device="meta")
    for r in range(m):
        local = rules.shard_for_rank(whole, cfg, m, r)
        assert local["embed"].shape == (n, d)
        assert local["head"].shape == (d, n)
        assert rules.vocab_block(cfg, m, r) == (r * n, n - r, r)
        assert rules.tp_degree(local, cfg) == m


@pytest.mark.parametrize("arch,m,kw,what", [
    ("olmoe-1b-7b", 4, {"num_experts": 6}, "6 experts"),
    ("yi-34b", 4, {"d_ff": 130}, "a hidden dim of 130"),
    ("yi-34b", 4, {"num_heads": 12, "num_kv_heads": 3}, "3 kv heads"),
    ("falcon-mamba-7b", 3, {}, "8192 SSM channels"),
    ("recurrentgemma-9b", 3, {"num_heads": 3}, "an RG-LRU width"),
])
def test_a_dim_the_layout_cannot_cut_raises_naming_config_and_m(arch, m, kw,
                                                                what):
    cfg = dataclasses.replace(get_config(arch), **kw)
    with pytest.raises(ValueError, match=f"{cfg.name}: the model axis of "
                                         f"{m} cannot cut {what}"):
        rules.exec_layout(cfg, m)


def test_tp_degree_reads_the_embedding():
    cfg = _reduced("minicpm-2b")
    params = init_params(cfg, device="meta")
    assert rules.tp_degree(params, cfg) == 1
    with pytest.raises(ValueError, match="neither whole"):
        rules.tp_degree({"embed": torch.empty(7, 5, device="meta")}, cfg)


def test_caches_pools_and_state_follow_the_layout():
    cfg = _reduced("yi-34b")
    m = 2
    params = init_params(cfg, seed=0, device="cpu")

    def fn(grid):
        cache = init_cache(cfg, 2, 8, device="cpu")
        local = shard_decode_cache(cfg, cache, grid)
        r = grid.axis_index("model")
        kvl = cfg.num_kv_heads // m
        assert local["k"].shape[3] == kvl
        assert torch.equal(local["k"], cache["k"][:, :, :, r * kvl:
                                                  (r + 1) * kvl])
        assert init_cache(cfg, 2, 8, device="cpu", tp=m)["k"].shape == \
            local["k"].shape
        assert init_pages(cfg, 4, 2, device="cpu", tp=m)["k"].shape[3] == kvl
        st = shard_train_state(init_train_state(params), cfg, grid)
        for p, mu in zip(tree_leaves(st.params), tree_leaves(st.opt.mu)):
            assert p.shape == mu.shape
        return True

    assert all(run_local_grid(fn, (m,), ("model",), "cpu"))


def test_params_from_jax_comes_across_as_a_rank_shards():
    jcfg, cfg = configs("falcon-mamba-7b")
    tree = jax_params_numpy(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    whole = params_from_jax(tree, cfg, "cpu")

    def fn(grid):
        local = params_from_jax(tree, cfg, "cpu", grid=grid)
        assert rules.tp_degree(local, cfg) == 2
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (2,), ("model",), "cpu"):
        for a, b in zip(tree_leaves(back), tree_leaves(whole)):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_grids_equal_the_reference_meshes(monkeypatch, multi_pod):
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (tuple(shape),
                                                               tuple(axes)))
    assert mesh.production_grid(multi_pod=multi_pod) == \
        jmesh.make_production_mesh(multi_pod=multi_pod)
    assert mesh.debug_grid(multi_pod=multi_pod) == \
        jmesh.make_debug_mesh(multi_pod=multi_pod)


def test_debug_grid_runs_as_rank_threads():
    shape, names = mesh.debug_grid()
    out = mesh.local_grid(lambda g: (g.axis_names, g.coords),
                          mesh.debug_grid(), "cpu")
    assert len(out) == int(np.prod(shape))
    assert out[5] == (names, (1, 1))
