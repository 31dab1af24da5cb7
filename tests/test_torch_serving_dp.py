"""Data-parallel serving of the port (``ContinuousBatchingServer(...,
grid=)`` and ``launch/serve.py --dp``): the slot rows striped over a
("data",) grid, every rank running the scheduler and the prefill, each
decoding its stripe, the sampled tokens assembled through the engine's
``allgather_inside``.

* Reduced ``minicpm-2b`` and ``olmoe-1b-7b`` (float32) on 2 and 4 rank
  threads: the greedy streams of every rank equal one rank's, with and
  without the prefix cache, under shared prompts and preemption.
* ``assembly_decision`` equals the reference engine's ``select`` for the
  same gather (``repro/serving/server.py:151-164``), and so does the
  regime; a batch the DP axis does not divide is refused, as in the
  reference.
* ``launch/serve.py --dp --device cpu`` under ``torch.distributed.run``
  with 2 gloo processes, and in one process (the world is that process
  alone), prints the digest of the streams of the run without ``--dp``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.serving as tserving
from repro.collectives.api import get_engine as j_get_engine
from repro_torch.collectives import CollectiveEngine, run_local_grid
from repro_torch.models import init_params
from repro_torch.serving import ContinuousBatchingServer
from torch_util import configs

ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(batch_size=4, max_len=32, block_size=4, prefill_chunk=8,
             num_blocks=1 + 12)


def _requests(vocab):
    rng = np.random.default_rng(7)
    shared = [rng.integers(0, vocab, 8) for _ in range(2)]
    out = []
    for rid in range(10):
        sfx = rng.integers(0, vocab, int(rng.integers(0, 6)))
        prompt = np.concatenate([shared[rid % 2], sfx]).astype(np.int32)
        out.append(tserving.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=int(rng.integers(5, 12))))
    return out


@pytest.fixture(scope="module", params=["minicpm-2b", "olmoe-1b-7b"])
def model(request):
    _, tcfg = configs(request.param)
    return tcfg, init_params(tcfg, seed=0, device="cpu")


def _serve(tcfg, params, grid=None, prefix_cache=True):
    engine = (CollectiveEngine(persist=False, device="cpu")
              if grid is not None else None)
    srv = ContinuousBatchingServer(tcfg, params, grid=grid, engine=engine,
                                   device="cpu", prefix_cache=prefix_cache,
                                   **SERVE)
    for req in _requests(tcfg.vocab_size):
        srv.submit(req)
    return srv.run(), srv.snapshot(), srv.assembly_decision


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix_cache", "no_prefix_cache"])
def test_dp_streams_equal_one_rank(model, ranks, prefix_cache):
    tcfg, params = model
    want, snap, _ = _serve(tcfg, params, prefix_cache=prefix_cache)
    assert snap.preemptions > 0
    assert (snap.cached_prefix_tokens > 0) == prefix_cache
    outs = run_local_grid(
        lambda g: _serve(tcfg, params, g, prefix_cache)[:2], (ranks,),
        ("data",), device="cpu")
    for got, rank_snap in outs:
        assert got == want
        assert rank_snap.decode_steps == snap.decode_steps


@pytest.mark.parametrize("batch,ranks", [(4, 2), (4, 4), (8, 4), (16, 8)])
def test_assembly_decision_equals_the_reference(batch, ranks):
    _, tcfg = configs("minicpm-2b")
    params = init_params(tcfg, seed=0, device="cpu")
    jeng = j_get_engine()
    want = jeng.select("allgather", batch * 4, ranks,
                       fabric=jeng.topology.for_axis("data"))

    def rank(grid):
        srv = ContinuousBatchingServer(
            tcfg, params, batch, 32, grid=grid,
            engine=CollectiveEngine(persist=False, device="cpu"),
            device="cpu", block_size=4)
        return srv.assembly_decision, srv.assembly_regime

    for dec, regime in run_local_grid(rank, (ranks,), ("data",),
                                      device="cpu"):
        assert (dec.op, dec.p, dec.nbytes, dec.algorithm) == \
            (want.op, want.p, want.nbytes, want.algorithm)
        assert dec.predicted == pytest.approx(want.predicted, rel=1e-12)
        assert regime == ("latency" if want.algorithm == "oneshot"
                          else "bandwidth")


def test_batch_not_divisible_by_the_dp_axis_is_refused():
    _, tcfg = configs("minicpm-2b")
    params = init_params(tcfg, seed=0, device="cpu")

    def rank(grid):
        with pytest.raises(ValueError, match="not divisible by dp axis 4"):
            ContinuousBatchingServer(tcfg, params, 6, 32, grid=grid,
                                     device="cpu")
        return True

    assert all(run_local_grid(rank, (4,), ("data",), device="cpu"))


_CLI = ["-m", "repro_torch.launch.serve", "--arch", "olmoe-1b-7b",
        "--device", "cpu", "--requests", "6", "--batch", "4",
        "--prompt-len", "12", "--new-tokens", "6", "--shared-prompts", "2"]


def _digest(out: str) -> str:
    found = re.findall(r"\[serve\] streams digest (\w+)", out)
    assert len(found) == 1, out
    return found[0]


def test_serve_cli_dp_under_torchrun_equals_one_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, *_CLI], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    alone = subprocess.run([sys.executable, *_CLI, "--dp"], env=env,
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=300)
    assert alone.returncode == 0, alone.stderr[-3000:]
    dp = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *_CLI, "--dp"], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert dp.returncode == 0, dp.stderr[-3000:]
    assert "dp axis 'data' = 2 ranks; token assembly: allgather[" in dp.stdout
    assert "dp axis 'data' = 1 ranks" in alone.stdout
    assert _digest(dp.stdout) == _digest(alone.stdout) == _digest(one.stdout)
