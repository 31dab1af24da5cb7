"""The RG-LRU hybrid's blocks sharded over "model": the RG-LRU on its lru
/ m channels (``w_x``, ``w_y`` column-parallel, its diagonal blocks of
``w_a`` / ``w_i``, ``out`` row-parallel) and the local attention on its
q heads with the one kv head (MQA: ``wk`` / ``wv`` whole on every rank),
against the JAX package's single-device results from the same weights
and inputs (reduced float32 ``recurrentgemma-9b`` at m 2 and 4, a prompt
of one window; ``tp_util``): ``forward_train`` logits and loss within
1e-5, the gradients gathered by ``unshard_params`` within 1e-4 of
``jax.grad``, prefill + greedy decode over the rings."""

import pytest

from tp_util import Model, check_forward, check_grads, check_greedy

ARCH = "recurrentgemma-9b"
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
