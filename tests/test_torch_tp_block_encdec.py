"""The encoder-decoder's blocks sharded over "model": the encoder's and
the decoder's self-attention and SwiGLU as the dense block, the
cross-attention's ``x_wq``, ``x_wk``, ``x_wv`` on the rank's heads and
``x_wo`` row-parallel, against the JAX package's single-device results
from the same weights, frames and tokens (reduced float32
``whisper-medium`` at m 2 and 4; ``tp_util``): ``forward_train`` logits
and loss within 1e-5, the gradients gathered by ``unshard_params`` within
1e-4 of ``jax.grad``, prefill + greedy decode (self and cross caches on
the rank's heads)."""

import pytest

from tp_util import Model, check_forward, check_grads, check_greedy

ARCH = "whisper-medium"
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
