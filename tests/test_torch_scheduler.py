"""The port's host-side serving bookkeeping (block allocator, prefix
cache, scheduler) replays the reference's traffic drivers with traces
identical to the JAX package's, step by step: admissions and their block
tables, copy-on-write copies, prefill plans, preemptions, allocator and
prefix-cache counters, and the token streams.

The driver is the one of tests/test_prefix_cache.py (``_drive``): a
host-side token pool stands in for the KV cache, and sampling is a pure
function of (request, position).
"""

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

import repro.serving as jserving
import repro.serving.blocks as jblocks
import repro.serving.scheduler as jsched
import repro_torch.serving as tserving
import repro_torch.serving.blocks as tblocks
import repro_torch.serving.scheduler as tsched

VOCAB = 64
PACKAGES = {
    "jax": SimpleNamespace(serving=jserving, blocks=jblocks, sched=jsched),
    "torch": SimpleNamespace(serving=tserving, blocks=tblocks, sched=tsched),
}


def _sim_token(rid, n_out):
    return (rid * 7919 + n_out * 31 + 5) % VOCAB


def _drive(pkg, specs, *, batch, capacity, bs, max_blocks, chunk, cache):
    """Run the trace ``specs`` = [(submit_step, rid, prompt, max_new)]
    through ``pkg``'s scheduler; return the per-step trace (retired
    requests carry their token streams)."""
    alloc = pkg.serving.BlockAllocator(capacity + pkg.blocks.RESERVED_BLOCKS,
                                       bs)
    pc = pkg.serving.PrefixCache(alloc) if cache else None
    sched = pkg.serving.Scheduler(batch, alloc, max_blocks, chunk,
                                  prefix_cache=pc)
    pending = deque((step, pkg.serving.Request(
        rid=rid, prompt=np.asarray(prompt, np.int32),
        max_new_tokens=max_new)) for step, rid, prompt, max_new in specs)
    pool = np.full((alloc.num_blocks, bs), -1, np.int64)
    trace, step = [], 0

    def append(req, tok):
        req.out.append(int(tok))
        if len(req.out) >= req.max_new_tokens:
            req.done = True

    while pending or sched.has_work():
        assert step < 3000, "driver did not converge"
        ev = {"step": step}
        while pending and pending[0][0] <= step:
            _, req = pending.popleft()
            sched.submit(req, now=float(step))
        ev["retired"] = [(r.rid, list(r.out))
                         for r in sched.retire_finished()]
        ev["admitted"] = [(r.rid, list(r.table.blocks),
                           r.cached_prefix_tokens)
                          for r in sched.admit(step)]
        ev["cow"] = sched.drain_cow_copies()
        for src, dst in ev["cow"]:
            pool[dst] = pool[src].copy()
        if sched.active():
            ev["plan"] = []
            for ch in sched.prefill_plan():
                req, replay = ch.req, ch.req.replay_tokens
                ev["plan"].append((req.rid, ch.start, ch.length))
                for p in range(ch.start, ch.start + ch.length):
                    pool[req.table.blocks[p // bs], p % bs] = replay[p]
                req.prefilled += ch.length
                req.ctx_len += ch.length
                sched.note_prefilled(req)
                if req.prefilled == len(replay):
                    req.state = pkg.sched.RUNNING
                    append(req, _sim_token(req.rid, len(req.out)))
            if sched.any_running():
                ev["preempted"] = [r.rid for r in sched.grow_for_decode()]
                ev["decode"] = []
                for row, req in sched.running():
                    pool[req.table.blocks[req.ctx_len // bs],
                         req.ctx_len % bs] = req.out[-1]
                    ev["decode"].append((row, req.rid, req.ctx_len,
                                         list(req.table.blocks)))
                    req.ctx_len += 1
                    append(req, _sim_token(req.rid, len(req.out)))
        ev["alloc"] = (alloc.num_used, alloc.num_free, alloc.num_evictable,
                       alloc.evictions)
        if pc is not None:
            ev["cache"] = (len(pc), pc.hits, pc.misses, pc.inserts)
        trace.append(ev)
        step += 1
    return trace


def _seeded_traffic():
    bs = 4
    rng = np.random.default_rng(0)
    base_a = rng.integers(0, VOCAB, 2 * bs)
    base_b = rng.integers(0, VOCAB, 2 * bs)

    def suffix(n, seed):
        return np.random.default_rng(seed).integers(0, VOCAB, n)

    specs = [
        (0, 0, np.concatenate([base_a, suffix(3, 1)]), 5),
        (1, 1, np.concatenate([base_a, suffix(2, 2)]), 4),
        (2, 2, base_a.copy(), 4),                     # full hit -> CoW
        (3, 3, np.concatenate([base_b, suffix(3, 3)]), 7),
        (4, 4, base_b.copy(), 3),
    ]
    max_blocks = -(-max(len(p) + n for _, _, p, n in specs) // bs)
    return specs, dict(batch=1, capacity=max_blocks + 1, bs=bs,
                       max_blocks=max_blocks, chunk=2 * bs)


def _preemption_traffic():
    bs = 4
    base = np.random.default_rng(7).integers(0, VOCAB, bs)
    specs = [(0, rid, np.concatenate(
        [base, np.random.default_rng(20 + rid).integers(0, VOCAB, 3)]), 8)
        for rid in range(4)]
    max_blocks = -(-(bs + 3 + 8) // bs)
    return specs, dict(batch=3, capacity=max_blocks + 1, bs=bs,
                       max_blocks=max_blocks, chunk=bs)


def _random_traffic(seed):
    rng = np.random.default_rng(seed)
    bs = int(rng.choice([2, 4]))
    bases = [rng.integers(0, VOCAB, bs * int(rng.integers(1, 4)))
             for _ in range(int(rng.integers(1, 4)))]
    specs = []
    for rid in range(int(rng.integers(2, 9))):
        base = bases[int(rng.integers(0, len(bases)))]
        prompt = np.concatenate(
            [base, rng.integers(0, VOCAB, int(rng.integers(0, 2 * bs + 1)))])
        specs.append((int(rng.integers(0, 7)), rid, prompt,
                      int(rng.integers(1, 2 * bs + 1))))
    specs.sort(key=lambda s: (s[0], s[1]))
    max_blocks = max(-(-(len(p) + n) // bs) for _, _, p, n in specs)
    return specs, dict(batch=int(rng.integers(1, 4)),
                       capacity=max_blocks + int(rng.integers(0, 5)), bs=bs,
                       max_blocks=max_blocks,
                       chunk=bs * int(rng.integers(1, 3)))


TRAFFIC = {"seeded": _seeded_traffic, "preemption": _preemption_traffic,
           **{f"random{s}": (lambda s=s: _random_traffic(s))
              for s in range(6)}}


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_scheduler_traces_identical(traffic, cache):
    specs, kw = TRAFFIC[traffic]()
    want = _drive(PACKAGES["jax"], specs, cache=cache, **kw)
    got = _drive(PACKAGES["torch"], specs, cache=cache, **kw)
    assert got == want


def test_traffic_exercises_the_machinery():
    """The fixed traces reach what they are meant to: cache hits,
    copy-on-write and eviction (seeded), preemption (preemption)."""
    specs, kw = _seeded_traffic()
    trace = _drive(PACKAGES["torch"], specs, cache=True, **kw)
    assert any(ev["cow"] for ev in trace)
    assert trace[-1]["cache"][1] > 0 and trace[-1]["alloc"][3] > 0
    specs, kw = _preemption_traffic()
    trace = _drive(PACKAGES["torch"], specs, cache=True, **kw)
    assert any(ev.get("preempted") for ev in trace)


def test_chain_keys_identical():
    toks = np.random.default_rng(5).integers(0, VOCAB, 37)
    for bs in (2, 4, 8):
        assert tserving.chain_keys(toks, bs) == jserving.chain_keys(toks, bs)
