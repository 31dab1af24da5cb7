"""A whole run of the training cell, at a tiny size on the CPU (the look
for a card skipped), judged by the real cell's limits: sound, it is
correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cell can have."""

from perfbench import run
from perfbench.lib import checks
from perfbench.tests import tiny

SEED = 2 ** 31 + 99
TRAIN = tiny.TRAIN


def judged(cell) -> bool:
    res = run.run_cell(cell, SEED, 1.0, False, device_type="cpu")
    line, _ = run.result_line(cell, res, False, "cpu", checks.limits(TRAIN))
    assert list(line)[-1] == "checks"
    return line["correct"]


def test_sound_training_is_correct():
    assert judged(tiny.train_cell())


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import step

    def unchanged(cfg, params, grads, state, *a, **k):
        return params, state, {"grad_norm": global_norm(grads), "lr": 0.0}
    monkeypatch.setattr(step, "apply_updates", unchanged)
    assert not judged(tiny.train_cell())


def test_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.train import step
    whole = step.value_and_grad

    def half(params, cfg, batch, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return whole(params, cfg, {k: v[:rows] for k, v in batch.items()},
                     **kw)
    monkeypatch.setattr(step, "value_and_grad", half)
    assert not judged(tiny.train_cell())


def test_a_cell_on_more_than_one_card_is_refused():
    import dataclasses

    import pytest
    cell = dataclasses.replace(tiny.train_cell(), chips=4)
    with pytest.raises(ValueError, match="one-card"):
        run.run_cell(cell, SEED, 1.0, False, device_type="cpu")


def test_the_checks_close_standard_error():
    cell = tiny.train_cell()
    limits = checks.limits(TRAIN)
    res = run.run_cell(cell, SEED, 1.0, False, device_type="cpu")
    _, rows = run.result_line(cell, res, False, "cpu", limits)
    assert [r[0] for r in rows] == list(limits)
