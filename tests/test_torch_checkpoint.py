"""The port's checkpoints and runtime against the JAX package's.

* Format: for one reduced config of every family (dense, MoE with and
  without its dense residual MLP, SSM, hybrid with a tail,
  encoder-decoder, vision) the port's ``.npz`` holds the reference's
  keys, arrays and ``__dtypes__`` byte for byte; a reference checkpoint
  restores into the port equal to ``params_from_jax`` of it; the
  reference's manager restores the port's file.  Exact throughout.
* The manager's protocol (round trip and ``keep``, a torn step, bf16)
  and the fault-tolerance pieces (heartbeats, stragglers, the elastic
  plan, the guard) give the reference's outputs on the same inputs.
* Asynchronous saves copy the tree before they return: an in-place
  update right after ``save(block=False)`` does not reach the file.
* The trainer: train then resume through ``launch.train.run`` (the
  reference's ``tests/test_system.py`` drill, 30 steps then 35), its
  losses equal the reference's at the tolerance of
  ``test_torch_train.py`` (1e-5 relative) on the same weights; a run
  preempted by SIGTERM and resumed gives an uninterrupted run's losses
  exactly; the reference's preemption fault (ROADMAP.md C29) and the
  port's deliberate difference; the same under ``--dp`` on two gloo
  processes, FSDP included.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint.manager import _flatten as j_flatten
from repro.models import init_params as j_init
from repro.train.state import init_train_state as j_init_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime import (HeartbeatMonitor, PreemptionGuard,
                                 StragglerDetector, plan_elastic_remesh)
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.tree import tree_leaves, tree_map
from torch_util import CPU, jax_params_numpy

ROOT = Path(__file__).resolve().parents[1]

#: one reduced config a family; the hybrid at 5 layers (one cycle of
#: three and a tail of two), arctic for the MoE's dense residual MLP
FAMILIES = {"dense": "minicpm-2b", "moe": "olmoe-1b-7b",
            "moe-dense-mlp": "arctic-480b", "ssm": "falcon-mamba-7b",
            "hybrid": "recurrentgemma-9b", "encdec": "whisper-medium",
            "vision": "llava-next-34b"}


def _configs(arch):
    jcfg = jax_configs.get_config(arch).reduced()
    tcfg = torch_configs.get_config(arch).reduced()
    if jcfg.family == "hybrid":
        jcfg = dataclasses.replace(jcfg, num_layers=5)
        tcfg = dataclasses.replace(tcfg, num_layers=5)
    return jcfg, tcfg


_STATES = {}


def _states(family):
    """The same train state in both packages (bf16 weights, float32
    moments drawn from a numpy seed, count 7)."""
    if family not in _STATES:
        jcfg, tcfg = _configs(FAMILIES[family])
        jp = j_init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(0)
        moment = lambda p: rng.normal(size=p.shape).astype(np.float32)
        mu = jax.tree.map(moment, jax_params_numpy(jp))
        nu = jax.tree.map(lambda p: np.abs(moment(p)), mu)
        js = j_init_state(jp)
        js = js._replace(opt=js.opt._replace(
            mu=jax.tree.map(jnp.asarray, mu),
            nu=jax.tree.map(jnp.asarray, nu), count=jnp.int32(7)))
        ts = TrainState(
            params=params_from_jax(jax_params_numpy(jp), tcfg, CPU),
            opt=adamw.AdamWState(mu=params_from_jax(mu, tcfg, CPU),
                                 nu=params_from_jax(nu, tcfg, CPU),
                                 count=7))
        _STATES[family] = (js, ts, tcfg)
    return _STATES[family]


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _zeros_like(state):
    return TrainState(params=_zeros(state.params),
                      opt=adamw.AdamWState(mu=_zeros(state.opt.mu),
                                           nu=_zeros(state.opt.nu), count=0))


def _assert_states_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not torch.is_tensor(b):
            assert type(a) is type(b) and a == b       # the count
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    assert got.opt.count == want.opt.count


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_file_is_the_references_format(family, tmp_path):
    js, ts, _ = _states(family)
    CheckpointManager(str(tmp_path), keep=2).save(3, ts)
    with np.load(tmp_path / "step_00000003" / "shard_0.npz") as z:
        got = {k: z[k] for k in z.files}
    want = j_flatten(js)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert bytes(got["__dtypes__"]) == bytes(want["__dtypes__"])
    dtypes = json.loads(bytes(got["__dtypes__"]).decode())
    assert dtypes[".params/embed"] == "bfloat16"
    assert got[".opt/.count"].dtype == np.int32
    assert got[".opt/.count"].shape == ()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_checkpoint_restores_into_the_port(family, tmp_path):
    js, ts, _ = _states(family)
    JManager(str(tmp_path), keep=2).save(5, js, metadata={"loss": 1.5})
    step, got, meta = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(ts))
    assert step == 5 and meta == {"loss": 1.5}
    _assert_states_equal(got, ts)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_manager_restores_the_port_file(family, tmp_path):
    js, ts, _ = _states(family)
    CheckpointManager(str(tmp_path)).save(4, ts)
    template = jax.tree.map(jnp.zeros_like, js)
    step, got, _ = JManager(str(tmp_path)).restore(template)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


def test_restore_onto_meta_template_and_device():
    """A template of meta tensors restores onto the device asked for, in
    the template's dtypes (the trainer's resume)."""
    _, ts, tcfg = _states("dense")
    from repro_torch.models import init_params
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(2, ts)
        template = init_train_state(init_params(tcfg, device="meta"))
        step, got, _ = mgr.restore(template, device="cpu")
    assert step == 2
    _assert_states_equal(got, ts)
    assert {t.device.type for t in tree_leaves(got)
            if torch.is_tensor(t)} == {"cpu"}
    assert [h["op"] for h in mgr.history] == ["save", "restore"]
    assert mgr.history[0]["bytes"] == mgr.history[1]["bytes"] > 0


# --------------------------- the protocol ----------------------------- #
def test_checkpoint_roundtrip_and_gc(tmp_path):
    """``tests/test_substrate.py``'s round trip, both managers on the
    same tree: the same committed steps, the same arrays."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}}
    results = []
    for cls, sub in ((JManager, "jax"), (CheckpointManager, "port")):
        mgr = cls(str(tmp_path / sub), keep=2)
        for step in (1, 2, 3):
            mgr.save(step, tree, metadata={"step": step})
        template = {"a": np.zeros((2, 3), np.float32),
                    "b": {"c": np.zeros(4, np.int32)}}
        results.append((mgr.committed_steps(), mgr.restore(template)))
    (j_steps, (j_step, j_tree, j_meta)), (t_steps, (t_step, t_tree,
                                                    t_meta)) = results
    assert t_steps == j_steps == [2, 3]
    assert (t_step, t_meta) == (j_step, j_meta) == (3, {"step": 3})
    np.testing.assert_array_equal(t_tree["a"], tree["a"])
    np.testing.assert_array_equal(t_tree["b"]["c"], j_tree["b"]["c"])
    assert t_tree["b"]["c"].dtype == np.int32


def test_checkpoint_torn_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"a": torch.ones(3)})
    # a torn step: shard written, COMMIT missing
    os.makedirs(tmp_path / "step_00000002", exist_ok=True)
    np.savez(tmp_path / "step_00000002" / "shard_0.npz", a=np.zeros(3))
    assert mgr.committed_steps() == JManager(str(tmp_path)).committed_steps()
    assert mgr.committed_steps() == [1]
    step, restored, _ = mgr.restore({"a": torch.zeros(3)})
    assert step == 1 and torch.equal(restored["a"], torch.ones(3))


def test_checkpoint_bf16_roundtrip(tmp_path):
    """bfloat16 leaves survive the npz round trip as uint16 bits and the
    dtype sidecar; the reference reads them as ``ml_dtypes.bfloat16``."""
    import ml_dtypes
    tree = {"w": torch.arange(8, dtype=torch.float32).to(torch.bfloat16)
            / 3, "b": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    _, restored, _ = mgr.restore({"w": torch.zeros(8, dtype=torch.bfloat16),
                                  "b": torch.zeros(3)})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    _, ref, _ = JManager(str(tmp_path)).restore(
        {"w": np.zeros(8, ml_dtypes.bfloat16), "b": np.zeros(3, np.float32)})
    assert ref["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(ref["w"].view(np.uint16),
                                  tree["w"].view(torch.int16).numpy()
                                  .view(np.uint16))


def test_async_save_writes_the_state_before_an_in_place_step(tmp_path):
    """``save(block=False)`` copies every leaf before it returns: the
    in-place AdamW step right after it does not reach the file."""
    _, ts, _ = _states("dense")
    state = TrainState(params=_zeros(ts.params), opt=ts.opt)
    for dst, src in zip(tree_leaves(state.params), tree_leaves(ts.params)):
        dst.copy_(src)
    before = [t.clone() for t in tree_leaves(state) if torch.is_tensor(t)]
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state, block=False)
    grads = _zeros(state.params)
    for g in tree_leaves(grads):
        g.fill_(0.5)
    _, opt, _ = adamw.apply_updates(adamw.AdamWConfig(lr=1e-2),
                                    state.params, grads, state.opt)
    after = [t.clone() for t in tree_leaves(state) if torch.is_tensor(t)]
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    mgr.wait()
    _, got, _ = mgr.restore(state)
    for g, b in zip([t for t in tree_leaves(got) if torch.is_tensor(t)],
                    before):
        assert torch.equal(g, b)
    assert got.opt.count == 7 and opt.count == 8
    assert mgr.history[0]["write_s"] > 0


def test_async_save_failure_raises_on_wait(tmp_path):
    """A write that fails in the thread is raised by the next ``wait``
    (here the step's directory name is taken by a file)."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"a": torch.ones(2)}, block=False)
    mgr.wait()
    (tmp_path / "step_00000002").write_text("in the way")
    mgr.save(2, {"a": torch.ones(2)}, block=False)
    with pytest.raises(RuntimeError, match="asynchronous"):
        mgr.wait()
    mgr.wait()                  # raised once
    assert mgr.committed_steps() == [1]


# --------------------------- fault tolerance -------------------------- #
def test_heartbeat_detects_dead_hosts():
    from repro.runtime import HeartbeatMonitor as JMonitor
    got = []
    for cls in (JMonitor, HeartbeatMonitor):
        clock = [0.0]
        mon = cls(["h0", "h1", "h2"], timeout_s=10, clock=lambda: clock[0])
        clock[0] = 5.0
        mon.beat("h0")
        clock[0] = 12.0
        mon.beat("h2")
        got.append(mon.dead_hosts())
    assert got[1] == got[0] == ["h1"]


def test_straggler_detection():
    from repro.runtime import StragglerDetector as JDetector
    got = []
    rng = np.random.default_rng(3)
    times = rng.uniform(0.8, 1.2, size=(20, 5))
    times[:, 2] *= 2.5
    for cls in (JDetector, StragglerDetector):
        det = cls(window=8, threshold=1.5)
        for row in times:
            for h, t in enumerate(row):
                det.record(f"h{h}", float(t))
        got.append(det.stragglers())
    assert got[1] == got[0]
    assert len(got[1]) == 1 and got[1][0][0] == "h2" and got[1][0][1] > 2.0


@pytest.mark.parametrize("failed", [set(), {"h3"}, {"h0", "h17", "h99"}])
def test_elastic_remesh_plan(failed):
    from repro.runtime import plan_elastic_remesh as j_plan
    kw = dict(mesh_shape=(2, 16, 16), axis_names=("pod", "data", "model"),
              hosts_per_slice=4, failed_hosts=failed,
              all_hosts=[f"h{i}" for i in range(128)], restore_step=1000)
    got, want = plan_elastic_remesh(**kw), j_plan(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.shrink_factor == want.shrink_factor
    assert got.new_mesh[2] == 16 and 0 < got.shrink_factor <= 1.0


def test_preemption_guard():
    g = PreemptionGuard(install=False)
    assert not g.should_stop
    g.request_stop()
    assert g.should_stop


def test_preemption_guard_catches_a_real_sigterm():
    previous = signal.getsignal(signal.SIGTERM)
    try:
        g = PreemptionGuard(install=True)
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.should_stop
    finally:
        signal.signal(signal.SIGTERM, previous)


#: the reference's tiny float32 config of ``tests/test_system.py``
TINY = dict(name="tiny-dense", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
            dtype="float32")


def test_elastic_restart_end_to_end(tmp_path):
    """The reference's node-failure drill in the port: train, save, plan
    the shrunken mesh, restore bit for bit, go on training on the smaller
    data axis."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step
    cfg = ArchConfig(**TINY)
    step_fn = make_train_step(cfg, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=0, total_steps=100))
    state = init_train_state(init_params(cfg, device="cpu"))
    data16 = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, 16))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(6):
        state, _ = step_fn(state, {k: torch.from_numpy(v) for k, v in
                                   data16.batch(step).items()})
    mgr.save(6, state)
    plan = plan_elastic_remesh(
        mesh_shape=(16, 16), axis_names=("data", "model"), hosts_per_slice=1,
        failed_hosts={"h3"}, all_hosts=[f"h{i}" for i in range(16)],
        restore_step=6)
    assert plan.new_mesh == (8, 16) and plan.restore_step == 6
    step_r, state_r, _ = mgr.restore(state)
    assert step_r == 6
    _assert_states_equal(state_r, state)
    data8 = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, 8))
    losses = []
    for step in range(6, 12):
        state_r, m = step_fn(state_r, {k: torch.from_numpy(v) for k, v in
                                       data8.batch(step).items()})
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))


# ------------------------------ the trainer --------------------------- #
@pytest.fixture
def tiny_trainers(monkeypatch):
    """Both trainers on the tiny float32 config, from the same weights:
    the port's ``init_params`` gives the reference's, converted."""
    import repro.launch.train as J
    from repro.configs.base import ArchConfig as JArchConfig
    from repro_torch.launch import train as T
    jcfg, tcfg = JArchConfig(**TINY), ArchConfig(**TINY)
    jp = jax_params_numpy(j_init(jax.random.PRNGKey(0), jcfg))
    real_init = T.init_params

    def init(cfg, seed=0, device=None):
        if device is not None and torch.device(device).type == "meta":
            return real_init(cfg, device="meta")
        return params_from_jax(jp, cfg, device)

    j_orig = J.get_config
    monkeypatch.setattr(J, "get_config",
                        lambda n: jcfg if n == jcfg.name else j_orig(n))
    monkeypatch.setattr(T, "init_params", init)
    # the reference's trainer installs its guard for good: put back the
    # handler the test found
    handler = signal.getsignal(signal.SIGTERM)
    yield J, T, tcfg
    signal.signal(signal.SIGTERM, handler)


def test_train_then_resume_matches_the_reference(tiny_trainers, tmp_path):
    """The reference's drill (``tests/test_system.py``): 30 steps with a
    checkpoint every 10, then the same directory to 35 steps, which runs
    only the 5 new ones.  Both packages, the same weights and batches:
    losses within 1e-5 relative."""
    J, T, tcfg = tiny_trainers
    kw = dict(batch_size=4, seq_len=64, reduced=False, lr=3e-3,
              log_every=100)
    got, want = [], []
    for run, cfg, out, sub in ((T.run, tcfg, got, "port"),
                               (J.run, tcfg.name, want, "jax")):
        extra = {"device": "cpu"} if run is T.run else {}
        d = str(tmp_path / sub)
        first = run(cfg, 30, ckpt_dir=d, ckpt_every=10, **kw, **extra)
        more = run(cfg, 35, ckpt_dir=d, ckpt_every=100, **kw, **extra)
        assert first[-1] < first[0]
        assert len(more) == 5               # only the new steps ran
        out.append(first + more)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert CheckpointManager(str(tmp_path / "port")).committed_steps() == \
        JManager(str(tmp_path / "jax")).committed_steps() == [30, 35]


class _GuardAfter:
    """A ``PreemptionGuard`` whose ``should_stop`` turns true at its
    ``n``-th poll (test-side: the train loop polls once a step)."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def __call__(self, install=True):
        return self

    @property
    def should_stop(self):
        self.polls += 1
        return self.polls >= self.n


def test_reference_preemption_commits_the_final_step_c29(tiny_trainers,
                                                          tmp_path,
                                                          monkeypatch):
    """ROADMAP.md C29, a fault of the reference: preempted after its
    third step, the run saves step 3 and then the same state again as
    step ``steps``; the resumed run finds step 10, runs nothing and
    raises at ``losses[-1]``."""
    J, _, tcfg = tiny_trainers
    monkeypatch.setattr(J, "PreemptionGuard", _GuardAfter(3))
    kw = dict(batch_size=4, seq_len=32, reduced=False, ckpt_dir=str(
        tmp_path), ckpt_every=100, log_every=100)
    assert len(J.run(tcfg.name, 10, **kw)) == 3
    assert JManager(str(tmp_path)).committed_steps() == [3, 10]
    monkeypatch.setattr(J, "PreemptionGuard", _GuardAfter(10 ** 6))
    with pytest.raises(IndexError):
        J.run(tcfg.name, 10, **kw)


def test_port_preemption_commits_only_the_step_in_flight(tiny_trainers,
                                                         tmp_path,
                                                         monkeypatch):
    """The port's difference (C29): preempted by a real SIGTERM during
    its third step, the run commits step 3 alone and returns; the resume
    runs the 7 remaining steps, with the losses of an uninterrupted run."""
    _, T, tcfg = tiny_trainers
    handler = signal.getsignal(signal.SIGTERM)
    kw = dict(batch_size=4, seq_len=32, ckpt_every=100, log_every=100,
              device="cpu")
    whole = T.run(tcfg, 10, ckpt_dir=str(tmp_path / "whole"), **kw)
    orig = T.make_train_step

    def make(*args, **kwargs):
        step_fn, calls = orig(*args, **kwargs), [0]

        def step(state, batch):
            calls[0] += 1
            if calls[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)
        return step

    monkeypatch.setattr(T, "make_train_step", make)
    first = T.run(tcfg, 10, ckpt_dir=str(tmp_path / "cut"), **kw)
    monkeypatch.setattr(T, "make_train_step", orig)
    assert len(first) == 3
    assert CheckpointManager(str(tmp_path / "cut")).committed_steps() == [3]
    rest = T.run(tcfg, 10, ckpt_dir=str(tmp_path / "cut"), **kw)
    assert first + rest == whole
    assert CheckpointManager(str(tmp_path / "cut")).committed_steps() == \
        [3, 10]
    # a resume at the end runs nothing and does not raise
    assert T.run(tcfg, 10, ckpt_dir=str(tmp_path / "cut"), **kw) == []
    # every run put back the SIGTERM handler it found
    assert signal.getsignal(signal.SIGTERM) == handler


def test_train_cli_checkpoint_flags(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--arch", "minicpm-2b", "--reduced", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    first = train.main([*argv, "--steps", "3"])
    assert CheckpointManager(str(tmp_path)).committed_steps() == [2, 3]
    more = train.main([*argv, "--steps", "5"])
    out = capsys.readouterr().out
    assert len(first) == 3 and len(more) == 2
    assert "[train] resumed from step 3" in out
    assert "saved step 4" in out and "restored step 3" in out


_DP_SCRIPT = r"""
import os, signal, sys
import numpy as np
import torch.distributed as dist
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train

out, mode = sys.argv[1], sys.argv[2]
dist.init_process_group("gloo")
rank = dist.get_rank()
kw = dict(batch_size=4, seq_len=32, ckpt_every=100, log_every=100,
          device="cpu", dp=True, grad_sync_mode=mode)
whole = train.run("minicpm-2b", 5, ckpt_dir=f"{out}/whole", **kw)
orig = train.make_train_step


def make(*args, **kwargs):
    step_fn, calls = orig(*args, **kwargs), [0]

    def step(state, batch):
        calls[0] += 1
        if calls[0] == 3 and rank == 1:     # one rank is preempted
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(state, batch)
    return step


train.make_train_step = make
first = train.run("minicpm-2b", 5, ckpt_dir=f"{out}/cut", **kw)
train.make_train_step = orig
steps = CheckpointManager(f"{out}/cut").committed_steps()
files = sorted(os.listdir(f"{out}/cut/step_00000003"))
rest = train.run("minicpm-2b", 5, ckpt_dir=f"{out}/cut", **kw)
np.save(f"{out}/{rank}.npy", np.asarray([whole, first + rest]))
if rank == 0:
    print("RESULT", len(first), steps, files, flush=True)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("mode", ["allreduce", "fsdp"])
def test_dp_preemption_and_resume_under_torchrun(tmp_path, mode):
    """Two gloo ranks: a SIGTERM to rank 1 during step 3 stops both after
    it; step 3 is committed (``shard_0`` alone under allreduce, one shard
    a rank under FSDP, whose moments are each rank's flat shard); the
    resume runs steps 3-4 with the uninterrupted run's losses, exactly."""
    script = tmp_path / "dp_ckpt.py"
    script.write_text(_DP_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(tmp_path), mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=tmp_path, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    shards = (["shard_0.npz", "shard_1.npz"] if mode == "fsdp"
              else ["shard_0.npz"])
    assert f"RESULT 3 [3] {['COMMIT', 'metadata.json', *shards]}" in out, out
    for rank in range(2):
        whole, resumed = np.load(tmp_path / f"{rank}.npy")
        np.testing.assert_array_equal(resumed, whole)


def test_restore_refuses_a_shard_whose_bytes_changed(tmp_path):
    """A shard whose array bytes changed after its write fails its zip
    CRC on restore instead of restoring other values."""
    import zipfile
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
            .to(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    step, back, _ = mgr.restore(tree)
    assert step == 1
    for k in tree:
        assert torch.equal(back[k], tree[k])
    shard = tmp_path / "step_00000001" / "shard_0.npz"
    raw = bytearray(shard.read_bytes())
    raw[raw.index(tree["a"].numpy().tobytes())] ^= 1
    shard.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        mgr.restore(tree)
