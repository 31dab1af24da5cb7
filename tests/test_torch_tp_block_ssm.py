"""The Mamba stack's block sharded over "model": each rank runs the scan
on its di / m channels (``in_proj`` its channels of x and of z,
``x_proj`` and ``out_proj`` row-parallel), against the JAX package's
single-device results from the same weights and inputs (reduced float32
``falcon-mamba-7b`` at m 2 and 4; ``tp_util``): ``forward_train`` logits
and loss within 1e-5, the gradients gathered by ``unshard_params`` within
1e-4 of ``jax.grad``, prefill + greedy decode (each rank's conv window
and state on its channels)."""

import pytest

from repro_torch.models import init_cache
from tp_util import Model, check_forward, check_grads, check_greedy

ARCH = "falcon-mamba-7b"
_MODELS = {}


def _model():
    if ARCH not in _MODELS:
        _MODELS[ARCH] = Model(ARCH)
    return _MODELS[ARCH]


@pytest.mark.parametrize("m", [2, 4])
def test_forward_and_loss_match_reference(m):
    check_forward(_model(), m)


@pytest.mark.parametrize("m", [2, 4])
def test_gradients_match_jax_grad(m):
    check_grads(_model(), m)


@pytest.mark.parametrize("m", [2, 4])
def test_prefill_and_greedy_decode_match_reference(m):
    check_greedy(_model(), m)


@pytest.mark.parametrize("m", [2, 4])
def test_a_rank_cache_holds_its_channels(m):
    cfg = _model().cfg
    cache = init_cache(cfg, 2, 8, device="cpu", tp=m)
    assert cache["conv"].shape[-1] == cfg.d_inner // m
    assert cache["h"].shape[2] == cfg.d_inner // m
