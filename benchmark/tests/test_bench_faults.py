"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run of a cell (at a tiny width, on the CPU, past
the harness's look for a chip) with one fault planted in the program, and
holds its readings to the cell's own limits: a step that leaves the state
unchanged, a step over half of each batch (the mean over the rest), an
answer altered where the model produces it. A sound run at the same size
passes (``test_bench_reference``). One chip: no exchange between chips to
leave out.
"""

import pytest
import torch

import tiny
from harness import cell as run_cell

TRAINING = ["vilbert_6l6c.cc_pretrain", "baseline_bert.cc_pretrain", "vilbert_6l6c.multitask12"]


def _run(name, seed=2 ** 35 + 3):
    torch.manual_seed(0)
    return run_cell.run(tiny.tiny_cell(name), seed, 0.3, False, device="cpu")


@pytest.mark.parametrize("name", TRAINING)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("name", TRAINING)
def test_state_left_unchanged(name, monkeypatch):
    from vilbert_tpu_torch.train import optim

    monkeypatch.setattr(optim.ReferenceAdamW, "step", lambda self, grads, **kw: None)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] > out["checks"]["update_gap"]["limit"]


@pytest.mark.parametrize("name", TRAINING)
def test_half_of_the_batch_left_out(name, monkeypatch):
    from vilbert_tpu_torch.parallel import train_step
    from vilbert_tpu_torch.train import multitask

    make = train_step.make_train_step

    def half_step(loss_fn, opt, **kw):
        def halved(model, batch):
            return loss_fn(model, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return make(halved, opt, **kw)

    monkeypatch.setattr(train_step, "make_train_step", half_step)
    monkeypatch.setattr(multitask, "make_train_step", half_step)
    assert not _run(name)["correct"]


def test_eval_sound_run_is_correct():
    assert _run("vilbert_6l6c.vqa_eval")["correct"]


def test_eval_answer_altered(monkeypatch):
    from vilbert_tpu_torch.models import vilbert

    forward = vilbert.SimpleClassifier.forward

    def altered(self, x):
        out = forward(self, x)
        out[0] = out[0].flip(0)  # one question's answer scores, reversed
        return out

    monkeypatch.setattr(vilbert.SimpleClassifier, "forward", altered)
    out = _run("vilbert_6l6c.vqa_eval")
    assert not out["correct"]
    for name in ("answer_gap_mean", "logit_err"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]
