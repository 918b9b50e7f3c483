"""Each cell's check catches the faults its timed path can have: a run at
the test's size with the timed path broken underneath (the harness's look
for a card skipped) comes out not correct. One card, so no exchange
between cards to leave out."""

import pytest

from benchmark.tests import tiny


def alter_answers(monkeypatch):
    """Every served clip's first final frame inverted where it is made."""
    from jafpro_tpu_torch import cli

    real = cli.generate_group

    def broken(gen):
        compute = real(gen)

        def run(group, clips):
            out = compute(group, clips)
            out["final"][:, 0] = 255 - out["final"][:, 0]
            return out
        return run

    monkeypatch.setattr(cli, "generate_group", broken)


@pytest.mark.parametrize("cell", ["gen-serve-batch1", "gen-request-refs1to4"])
def test_served_answer_altered(tiny_root, monkeypatch, cell):
    assert tiny.run(tiny_root, cell)["correct"]
    alter_answers(monkeypatch)
    res = tiny.run(tiny_root, cell)
    assert not res["correct"]
    c = res["checks"]["final_lsb"]
    assert c["value"] > c["limit"]


def state_unchanged(monkeypatch):
    from jafpro_tpu_torch.train.common import TrainState

    def apply(self, grads):
        for name in grads:
            self.opts[name].zero_grad(set_to_none=True)
        self.step += 1
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", apply)


def half_batch(monkeypatch):
    from jafpro_tpu_torch import cli

    real = cli.make_step

    def make(pipe, stage):
        step, lrs = real(pipe, stage)

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half, lrs

    monkeypatch.setattr(cli, "make_step", make)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_training_fault(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    res = tiny.run(tiny_root, "train4-batch4")
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_training_sound(tiny_root):
    res = tiny.run(tiny_root, "train4-batch4")
    assert res["correct"], res["checks"]
