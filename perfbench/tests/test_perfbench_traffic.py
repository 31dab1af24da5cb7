"""The generators: training batches and weights, deterministic from the
seed."""

import torch

from perfbench.drivers import train
from perfbench.lib import weights
from perfbench.tests import tiny


def test_training_batches_repeat_and_differ_by_step():
    a = train.batch(7, 0, 4, 16, 100, "cpu")
    b = train.batch(7, 0, 4, 16, 100, "cpu")
    c = train.batch(7, 1, 4, 16, 100, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = train.batch(7, 0, 4, 16, 100, "cpu", 2)
    assert torch.equal(rows["tokens"], a["tokens"][:2])


def test_training_batches_take_a_seed_past_32_bits():
    a = train.batch(2 ** 31 + 11, 0, 2, 8, 100, "cpu")
    b = train.batch(2 ** 33 + 11, 0, 2, 8, 100, "cpu")
    assert not torch.equal(a["tokens"], b["tokens"])


def test_weights_repeat_and_the_float32_copy_is_the_same_values():
    arch = tiny.DENSE
    a = weights.make_tree(arch, 5, "cpu")
    b = weights.make_tree(arch, 5, "cpu", torch.float32)
    names = [weights.name(p) for p, *_ in weights.leaf_specs(arch)]
    for path, *_ in weights.leaf_specs(arch):
        x, y = weights.get(a, path), weights.get(b, path)
        assert torch.equal(x.float(), y), path
    assert len(names) == len(set(names))
    c = weights.make_tree(arch, 6, "cpu")
    assert not torch.equal(a["embed"], c["embed"])
