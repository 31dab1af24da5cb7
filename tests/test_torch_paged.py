"""The port's paged model path against the JAX package's: chunked
prefill and decode logits on the same weights (moved across with
``params_from_jax``), float32, the reference's own bound of 2e-4, for
the dense family, the MoE family (``olmoe-1b-7b``) and the vision
config's text path (``llava-next-34b``, no soft tokens); pool
copy-on-write and scratch-block isolation; the weight conversion and
initialisation layout."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import (decode_step_paged as j_decode,
                          forward_paged as j_forward, init_pages as j_pages,
                          init_params as j_init)
from repro_torch.convert import params_from_jax
from repro_torch.models import (copy_blocks, decode_step_paged,
                                forward_paged, init_pages, init_params,
                                supports_paged)
from torch_util import CPU, configs, jax_params_numpy, port_params


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _paged_logits(arch, chunk):
    """Chunked paged prefill then one decode step through both packages
    on the same weights and tokens; returns the logits of each."""
    jcfg, tcfg = configs(arch)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp, tcfg)
    rng = np.random.default_rng(1)
    S, bs = 12, 8
    toks = rng.integers(0, jcfg.vocab_size, size=(1, S)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, size=(1, 1)).astype(np.int32)
    bt = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
    jpages, tpages = j_pages(jcfg, 10, bs), init_pages(tcfg, 10, bs, CPU)
    ctx, off, out = 0, 0, {"j": [], "t": []}
    while off < S:
        n = min(chunk, S - off)
        tb = np.zeros((1, chunk), np.int32)
        tb[:, :n] = toks[:, off:off + n]
        c = np.asarray([ctx], np.int32)
        nl = np.asarray([n], np.int32)
        lg, jpages = j_forward(jp, jcfg, jpages, {"tokens": jnp.asarray(tb)},
                               jnp.asarray(bt), jnp.asarray(c),
                               jnp.asarray(nl))
        out["j"].append(np.asarray(lg)[:, :n])
        lg, tpages = forward_paged(tp, tcfg, tpages, {"tokens": _t(tb)},
                                   _t(bt), _t(c), _t(nl))
        out["t"].append(lg[:, :n].numpy())
        ctx += n
        off += n
    c = np.asarray([ctx], np.int32)
    lg, _ = j_decode(jp, jcfg, jpages, {"tokens": jnp.asarray(nxt)},
                     jnp.asarray(bt), jnp.asarray(c))
    out["j"].append(np.asarray(lg))
    for use_kernel in (False, True):
        pages = {k: v.clone() for k, v in tpages.items()}
        lg, _ = decode_step_paged(tp, tcfg, pages, {"tokens": _t(nxt)},
                                  _t(bt), _t(c), use_kernel=use_kernel)
        out["t"].append(lg.numpy())
    out["j"].append(out["j"][-1])
    # the pools the two packages wrote during prefill
    out["pages"] = (np.asarray(jpages["k"]), tpages["k"].numpy())
    return out


@pytest.mark.parametrize("arch", ["minicpm-2b", "mistral-nemo-12b",
                                  "olmoe-1b-7b", "llava-next-34b"])
@pytest.mark.parametrize("chunk", [8, 12])
def test_paged_prefill_and_decode_match_jax(arch, chunk):
    """MHA (minicpm) and GQA (mistral-nemo): every prefill chunk's valid
    logits, the decode logits through the gathered path and through the
    kernel entry point, and the written KV pool agree with the
    reference within 2e-4."""
    out = _paged_logits(arch, chunk)
    assert len(out["j"]) == len(out["t"])
    for want, got in zip(out["j"], out["t"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    jk, tk = out["pages"]
    np.testing.assert_allclose(tk, jk, rtol=0, atol=2e-4)


def test_copy_blocks_in_place_matches_jax():
    jcfg, tcfg = configs("minicpm-2b")
    rng = np.random.default_rng(4)
    k = rng.normal(size=(2, 6, 4, 4, 16)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    src, dst = np.asarray([1, 1, 3], np.int32), np.asarray([2, 4, 5],
                                                           np.int32)
    from repro.models.paged import copy_blocks as j_copy
    want = j_copy({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                  jnp.asarray(src), jnp.asarray(dst))
    pages = {"k": _t(k.copy()), "v": _t(v.copy())}
    got = copy_blocks(pages, _t(src), _t(dst))
    assert got["k"] is pages["k"], "the pool is updated in place"
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_scratch_block_isolates_invalid_writes():
    """Padded tail positions land in scratch block 0, leaving allocated
    blocks untouched."""
    jcfg, tcfg = configs("minicpm-2b")
    params = port_params(j_init(jax.random.PRNGKey(0), jcfg), tcfg)
    pages = init_pages(tcfg, 6, 8, CPU)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tcfg.vocab_size, (1, 8)))
    _, pages2 = forward_paged(params, tcfg, pages, {"tokens": toks},
                              torch.tensor([[1, 2]], dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32),
                              torch.tensor([5], dtype=torch.int32))
    k = pages2["k"].numpy()
    assert np.any(k[:, 1, :5] != 0), "valid positions must be written"
    assert np.all(k[:, 1, 5:] == 0), "padded tail leaked into block 1"
    assert np.all(k[:, 2] == 0), "padded tail leaked into block 2"
    assert np.any(k[:, 0] != 0), "scratch block should absorb the tail"
    assert np.all(k[:, 3:] == 0), "unallocated blocks must stay clean"


def test_params_from_jax_bf16_is_bit_exact():
    jcfg, tcfg = configs("minicpm-2b", dtype="bfloat16")
    tree = jax_params_numpy(j_init(jax.random.PRNGKey(3), jcfg))
    params = params_from_jax(tree, tcfg, CPU)
    assert params["embed"].dtype == torch.bfloat16
    assert len(params["layers"]) == jcfg.num_layers
    for i, layer in enumerate(params["layers"]):
        for name, t in layer.items():
            want = tree["layers"][name][i].view(np.uint16)
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16), want)


def test_init_params_layout_matches_jax():
    jcfg, tcfg = configs("mistral-nemo-12b")
    tree = jax_params_numpy(j_init(jax.random.PRNGKey(0), jcfg))
    params = init_params(tcfg, seed=0, device="cpu")
    for name in ("embed", "ln_f", "head"):
        assert tuple(params[name].shape) == tree[name].shape
    for i, layer in enumerate(params["layers"]):
        assert set(layer) == set(tree["layers"])
        for name, t in layer.items():
            assert tuple(t.shape) == tree["layers"][name].shape[1:]
            assert t.dtype == torch.float32
    assert torch.all(params["layers"][0]["ln1"] == 0)
    # same seed, same weights; another seed, other weights
    again = init_params(tcfg, seed=0, device="cpu")
    other = init_params(tcfg, seed=1, device="cpu")
    assert torch.equal(again["head"], params["head"])
    assert not torch.equal(other["head"], params["head"])


def test_paged_rejects_unported_families():
    """The SSM keeps its constant-size state; the MoE family and the
    vision config serve, as in the reference (``test_paged_prefill_and_
    decode_match_jax``; soft tokens: ``test_torch_vlm.py``)."""
    for arch in ("olmoe-1b-7b", "llava-next-34b"):
        assert supports_paged(configs(arch)[1])
    assert init_pages(configs("llava-next-34b")[1], 8, 16, CPU)["k"].shape[1] \
        == 8
    _, tcfg = configs("falcon-mamba-7b")
    assert not supports_paged(tcfg)
    with pytest.raises(NotImplementedError):
        init_pages(tcfg, 8, 16, CPU)
