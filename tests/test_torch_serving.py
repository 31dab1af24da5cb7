"""The port's continuous-batching server against the JAX package's:
greedy token streams identical on the same weights (reduced minicpm-2b,
float32) under shared prompts and preemption; the port's own contract
that the prefix cache leaves greedy streams bitwise unchanged; the
sampling contract; and the device default (CUDA or an error, never a
quiet CPU run)."""

import numpy as np
import jax
import pytest
import torch
from scipy import stats

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.models import init_params as j_init
from repro_torch.serving import (ContinuousBatchingServer, Request,
                                 SamplingParams, sample_tokens)
from repro_torch.serving.sampling import gumbel_noise
from torch_util import CPU, configs, port_params

ARCH = "minicpm-2b"
SERVE = dict(batch_size=3, max_len=32, block_size=4, prefill_chunk=8,
             num_blocks=1 + 14)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs(ARCH)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, port_params(jp, tcfg)


def _requests(pkg, vocab):
    """8 requests over 2 shared system prompts, one exact repeat (full
    prefix hit, copy-on-write), and enough decode to exhaust the pool."""
    rng = np.random.default_rng(42)
    shared = [rng.integers(0, vocab, 8) for _ in range(2)]
    out = []
    for rid in range(8):
        sfx = rng.integers(0, vocab, int(rng.integers(0, 6)))
        if rid == 5:
            sfx = sfx[:0]
        prompt = np.concatenate([shared[rid % 2], sfx]).astype(np.int32)
        out.append(pkg.Request(rid=rid, prompt=prompt,
                               max_new_tokens=int(rng.integers(6, 13))))
    return out


def _serve_torch(tcfg, tp, prefix_cache=True):
    srv = ContinuousBatchingServer(tcfg, tp, device="cpu",
                                   prefix_cache=prefix_cache, **SERVE)
    for req in _requests(tserving, tcfg.vocab_size):
        srv.submit(req)
    return srv.run(), srv.snapshot()


def test_greedy_streams_match_jax_server(weights):
    jcfg, jp, tcfg, tp = weights
    jsrv = jserving.ContinuousBatchingServer(jcfg, jp, **SERVE)
    for req in _requests(jserving, jcfg.vocab_size):
        jsrv.submit(req)
    want = jsrv.run()
    got, snap = _serve_torch(tcfg, tp)
    jsnap = jsrv.snapshot()
    assert got == want
    assert all(len(v) >= 6 for v in got.values())
    # the run really shares prefixes and preempts, in both packages
    assert snap.cached_prefix_tokens > 0 and snap.preemptions > 0
    assert (snap.cached_prefix_tokens, snap.preemptions,
            snap.decode_steps, snap.prefill_chunks) == \
        (jsnap.cached_prefix_tokens, jsnap.preemptions,
         jsnap.decode_steps, jsnap.prefill_chunks)


def test_prefix_cache_on_off_bitwise(weights):
    _, _, tcfg, tp = weights
    on, snap_on = _serve_torch(tcfg, tp, prefix_cache=True)
    off, snap_off = _serve_torch(tcfg, tp, prefix_cache=False)
    assert on == off
    assert snap_on.prefill_tokens_computed < snap_off.prefill_tokens_computed
    assert snap_off.cached_prefix_tokens == 0


def test_sampled_serving_placement_invariant(weights):
    """A stochastic request emits the same tokens alone and in a busy
    batch (ids travel with (request, position), not the slot)."""
    _, _, tcfg, tp = weights
    target = Request(rid=3, prompt=np.arange(5, dtype=np.int32),
                     max_new_tokens=6,
                     sampling=SamplingParams(temperature=0.8, top_k=16))

    def serve(others):
        srv = ContinuousBatchingServer(tcfg, tp, device="cpu", seed=7,
                                       batch_size=3, max_len=32,
                                       block_size=4)
        for rid in range(others):
            srv.submit(Request(rid=10 + rid,
                               prompt=np.full(7, rid, np.int32),
                               max_new_tokens=4))
        srv.submit(Request(rid=target.rid, prompt=target.prompt.copy(),
                           max_new_tokens=target.max_new_tokens,
                           sampling=target.sampling))
        return srv.run()[target.rid]

    alone, busy = serve(0), serve(4)
    assert alone == busy
    assert all(0 <= t < tcfg.vocab_size for t in alone)


def test_sampling_greedy_is_argmax_first_on_ties():
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32))
    logits[2, 5] = logits[2, 9] = logits[2].max() + 1.0
    toks = sample_tokens(logits, torch.arange(4), torch.zeros(4), seed=0)
    np.testing.assert_array_equal(toks.numpy(),
                                  np.argmax(logits.numpy(), -1))
    assert toks[2] == 5


def test_sampling_top_k_support_and_determinism():
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(size=(6, 64)).astype(np.float32))
    temps = torch.full((6,), 0.7)
    a = sample_tokens(logits, torch.arange(6), temps, 1, top_ks=4)
    b = sample_tokens(logits, torch.arange(6), temps, 1, top_ks=4)
    assert torch.equal(a, b)
    top4 = np.argsort(logits.numpy(), -1)[:, -4:]
    for i, t in enumerate(a.numpy()):
        assert t in top4[i], "sampled token outside the top-k set"
    c = sample_tokens(logits, torch.arange(6) + 100, temps, 1, top_ks=4)
    assert not torch.equal(a, c)
    # per-row k: k=1 forces the argmax even at a high temperature
    ks = torch.tensor([1, 0, 1, 0, 1, 0], dtype=torch.int32)
    toks = sample_tokens(logits * 4, torch.arange(6), torch.full((6,), 5.0),
                         1, ks)
    np.testing.assert_array_equal(toks.numpy()[::2],
                                  np.argmax(logits.numpy(), -1)[::2])


def test_sampling_mixed_rows_and_noise_contract():
    logits = torch.from_numpy(
        np.random.default_rng(2).normal(size=(4, 32)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 1.0])
    toks = sample_tokens(logits, torch.arange(4), temps, 3).numpy()
    argmax = np.argmax(logits.numpy(), -1)
    assert toks[0] == argmax[0] and toks[2] == argmax[2]
    # the noise of a row depends on (seed, id) only, not on its position
    g = gumbel_noise(3, torch.tensor([7, 9]), 32)
    g_swapped = gumbel_noise(3, torch.tensor([9, 7]), 32)
    assert torch.equal(g[0], g_swapped[1]) and torch.isfinite(g).all()
    assert not torch.equal(g, gumbel_noise(4, torch.tensor([7, 9]), 32))


def test_sampling_distribution_chi_square():
    """Draws over many ids follow softmax(logits / T) on a small vocab."""
    v, n = 6, 6000
    logits = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -1.0])
    temp = 0.8
    toks = sample_tokens(logits.expand(n, v), torch.arange(n),
                         torch.full((n,), temp), seed=11)
    counts = np.bincount(toks.numpy(), minlength=v)
    probs = torch.softmax(logits / temp, -1).numpy().astype(np.float64)
    _, p = stats.chisquare(counts, probs / probs.sum() * n)
    assert p > 1e-3, (counts, probs * n)


def test_server_defaults_to_cuda_and_refuses_silent_cpu(weights):
    _, _, tcfg, tp = weights
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingServer(tcfg, tp, batch_size=2, max_len=16)
    from repro_torch.models import init_params
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(tcfg)
    # asked for explicitly, the CPU serves
    ContinuousBatchingServer(tcfg, tp, batch_size=2, max_len=16,
                             device=CPU)


def test_unsupported_family_raises():
    _, tcfg = configs("falcon-mamba-7b")
    with pytest.raises(NotImplementedError):
        ContinuousBatchingServer(tcfg, None, batch_size=2, max_len=32,
                                 device="cpu")


def test_serve_cli_refuses_the_hybrid_as_the_reference_does():
    """The hybrid trains, prefills and decodes over its dense ring cache,
    but is not a paged family: the serve CLI refuses it with the
    reference's reason."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="family 'hybrid'.* not servable: "
                       "the paged KV cache covers the dense and MoE decoder "
                       "families"):
        serve.main(["--arch", "recurrentgemma-9b", "--device", "cpu"])


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    shared = ["--device", "cpu", "--requests", "3", "--batch", "2",
              "--prompt-len", "8", "--new-tokens", "3",
              "--shared-prompts", "2"]
    single = serve.main(shared)
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out
    # the fleet flags serve (tests/test_torch_fleet.py), with the single
    # server's streams: two replicas behind the default router and
    # behind the cost router
    for flags in (["--replicas", "2"],
                  ["--replicas", "2", "--router", "cost"]):
        assert serve.main([*shared, *flags]) == single
    # --dp serves (test_torch_serving_dp.py); in one process the DP axis
    # is that process alone, and the streams are the same
    plain = serve.main(["--device", "cpu", "--requests", "3", "--batch",
                        "2", "--prompt-len", "8", "--new-tokens", "3"])
    dp = serve.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                     "--prompt-len", "8", "--new-tokens", "3", "--dp"])
    assert dp == plain
    assert "dp axis 'data' = 1 ranks" in capsys.readouterr().out
