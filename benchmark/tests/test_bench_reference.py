"""The plain reference against the program at a tiny width, in float32.

The program (``vilbert_tpu_torch``) runs its plain PyTorch twins on the
CPU; both are given the benchmark's seeded weights, batches and dropout
seeds. The reference itself imports nothing of the program."""

import os
import subprocess
import sys

import pytest
import torch

import tiny
from harness import cell as run_cell
from harness import seeded
from reference.model import PRETRAINING, Config, ViLBERTForVLTasks
from reference.train import decayed

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 on both sides: the sums run in other orders (fused LayerNorm
# statistics, the plain attention's batched products), so losses and the
# first gradients agree to a few float32 roundings (~1e-6 of the median
# leaf); a parameter's change after the first steps carries the rounding of
# LayerNorm scales near 1 (an ulp of 1.0 is 1.2e-7 against changes of ~1e-4
# a step), up to ~3e-3 of the change on the worst leaf
FP32 = {"loss_gap": 1e-6, "grad_gap": 1e-5, "update_gap": 3e-3, "grad_err_median": 1e-5,
        "answer_gap_mean": 1e-6, "logit_err": 1e-5}


CELLS = ["vilbert_6l6c.cc_pretrain", "baseline_bert.cc_pretrain", "vilbert_6l6c.vqa_eval",
         "vilbert_6l6c.multitask12"]


def _models(cell):
    """(the program's model, the reference's) of a cell, on the meta device."""
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks as Program
    from vilbert_tpu_torch.train.pretrain import pretrain_model

    kind = cell.traffic["kind"]
    tokens = kind == "multitask"
    cfg = run_cell.Context(cell, 0, "cpu").model_config().replace(task_specific_tokens=tokens)
    with torch.device("meta"):
        if kind == "pretrain":
            return (pretrain_model(cfg, cell.config["family"]),
                    PRETRAINING[cell.config["family"]](Config(cell.config)))
        labels = cell.traffic["num_labels"]
        return (Program(cfg, num_labels=labels),
                ViLBERTForVLTasks(Config(cell.config, task_specific_tokens=tokens),
                                  num_labels=labels))


@pytest.mark.parametrize("name", CELLS)
def test_same_names_and_shapes(name):
    program, ref = _models(tiny.tiny_cell(name))
    shapes = {n: tuple(p.shape) for n, p in program.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in ref.named_parameters()}


@pytest.mark.parametrize("name", CELLS)
def test_same_weight_decay(name):
    """Both sides decay the same parameters."""
    from vilbert_tpu_torch.train.optim import decay_mask

    cell = tiny.tiny_cell(name)
    program, _ = _models(cell)
    names = [n for n, _ in program.named_parameters()]
    family = cell.config["family"]
    if family == "vilbert":
        assert decay_mask(names) == {n: decayed(n) for n in names}
    else:  # the program reads the baseline's flax paths
        from vilbert_tpu_torch.core.importer import _to_flax_key

        flax = {n: _to_flax_key(n, family) for n in names}
        want = {n: not any(s in flax[n] for s in ("bias", "LayerNorm.weight")) for n in names}
        assert want == {n: decayed(n) for n in names}


def test_seeded_weights_repeat_and_differ():
    shapes = [("a.weight", (3, 4)), ("a.bias", (3,)), ("n.LayerNorm.weight", (4,)),
              ("b.weight", (2, 2))]
    one = seeded.weights(shapes, 2 ** 40 + 5, 0.02, "cpu")
    assert all(torch.equal(one[k], v) for k, v in
               seeded.weights(reversed(shapes), 2 ** 40 + 5, 0.02, "cpu").items())
    assert not torch.equal(one["a.weight"], seeded.weights(shapes, 6, 0.02, "cpu")["a.weight"])
    assert torch.equal(one["a.bias"], torch.zeros(3))
    assert torch.equal(one["n.LayerNorm.weight"], torch.ones(4))


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program_in_fp32(name):
    torch.manual_seed(0)
    out = run_cell.run(tiny.tiny_cell(name), 2 ** 33 + 17, 0.3, False, device="cpu")
    for check, c in out["checks"].items():
        assert c["value"] <= FP32[check], (check, c["value"])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.model, reference.train, "
            "reference.dropout; bad = sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('vilbert_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)") % BENCH_DIR
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_run_refuses_a_machine_without_cuda(monkeypatch, capsys):
    """run.py exits non-zero and prints no result where CUDA is missing."""
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "vilbert_6l6c.cc_pretrain", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_import_guard_names_whole_top_level_modules(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "vilbert_tpu_torch_extra", sys)
    assert "vilbert_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vilbert_tpu.models", sys)
    assert run.forbidden_modules() == ["vilbert_tpu"]
