"""The MoE decoder's block sharded over "model": each rank holds E / m
experts (``sharding.rules.shard_params``), the router whole, against the
JAX package's single-device results from the same weights and inputs
(reduced float32 ``olmoe-1b-7b`` at m 2 and 4, ``arctic-480b`` with its
dense residual at m 2; ``tp_util``): ``forward_train`` logits and loss
within 1e-5 (the load-balance term included), the gradients gathered by
``unshard_params`` within 1e-4 of ``jax.grad``, prefill + greedy decode,
and the paged chunk and decode step."""

import pytest

from repro_torch.sharding.rules import shard_for_rank
from tp_util import (Model, check_forward, check_grads, check_greedy,
                     check_paged)

CASES = [("olmoe-1b-7b", 2), ("olmoe-1b-7b", 4), ("arctic-480b", 2)]
IDS = [f"{a}-m{m}" for a, m in CASES]
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = Model(arch)
    return _MODELS[arch]


@pytest.mark.parametrize("arch,m", CASES, ids=IDS)
def test_forward_and_loss_match_reference(arch, m):
    check_forward(_model(arch), m)


@pytest.mark.parametrize("arch,m", CASES, ids=IDS)
def test_gradients_match_jax_grad(arch, m):
    check_grads(_model(arch), m)


@pytest.mark.parametrize("arch,m", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_reference(arch, m):
    check_greedy(_model(arch), m)


@pytest.mark.parametrize("arch,m", [("olmoe-1b-7b", 2)])
def test_paged_chunk_and_decode_match_reference(arch, m):
    check_paged(_model(arch), m)


@pytest.mark.parametrize("m", [2, 4])
def test_a_rank_holds_its_experts_and_the_whole_router(m):
    model = _model("olmoe-1b-7b")
    e = model.cfg.num_experts
    for r in range(m):
        lp = shard_for_rank(model.params, model.cfg, m, r)["layers"][0]
        whole = model.params["layers"][0]
        assert lp["router"] is whole["router"]
        for name in ("eg", "eu", "ed"):
            assert lp[name].shape[0] == e // m
            assert lp[name].equal(whole[name][r * e // m:(r + 1) * e // m])


def test_expert_parallel_dispatch_on_a_rank_experts():
    """``moe_ep`` on a rank's tree (its E / m experts taken as they stand,
    the rows split over "model" and exchanged) equals the whole tree's EP
    route under the same grid (which cuts its experts itself): loss and
    gathered gradients."""
    import dataclasses

    import torch

    from repro_torch.collectives import run_local_grid
    from repro_torch.models.layers import ambient_grid
    from repro_torch.sharding.rules import shard_params, unshard_params
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_leaves

    model = _model("olmoe-1b-7b")
    cfg = dataclasses.replace(model.cfg, moe_ep=True,
                              moe_ep_algorithm="lax")
    batch = model.tbatch()

    def rank(grid, sharded):
        with ambient_grid(grid):
            if not sharded:
                loss, _, grads = value_and_grad(model.params, cfg, batch)
                return loss, grads
            local = shard_params(model.params, cfg, grid)
            loss, _, grads = value_and_grad(local, cfg, batch)
            return loss, unshard_params(grads, cfg, grid)

    whole = run_local_grid(lambda g: rank(g, False), (2,), ("model",),
                           "cpu")
    cut = run_local_grid(lambda g: rank(g, True), (2,), ("model",), "cpu")
    for (wl, wg), (cl, cg) in zip(whole, cut):
        assert float(cl) == pytest.approx(float(wl), abs=1e-6)
        for a, b in zip(tree_leaves(cg), tree_leaves(wg)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
