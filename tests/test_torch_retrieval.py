"""The port's retrieval evaluation and demo against the JAX package, on the CPU.

The scorers (``vil_logit`` with ``fast_mode``, the zero-shot alignment
score) against the JAX scorers on the same weights (carried across by
``core.weights``) within 1e-4; ``evaluate_retrieval``'s chunk-outer loop;
``cli/eval_retrieval.py --synthetic`` with a JAX-saved ``.npz`` against
``vilbert_tpu.cli.eval_retrieval``'s metrics JSON; ``cli/demo.py`` against
the root ``demo.py``'s lines. Tiny configs, fp32, no dropout.
"""

import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

REPO = Path(__file__).resolve().parents[1]
T, R, CHUNK = 7, 6, 4

_TINY = dict(
    vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
    v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
    v_intermediate_size=48, v_target_size=11, bi_hidden_size=32,
    bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1],
    compute_dtype="float32",
)


def _caption_and_chunk(cfg, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones(T, np.int32)
    mask[-2:] = 0
    caption = {"question": rng.randint(1, cfg.vocab_size, T).astype(np.int32),
               "input_mask": mask, "segment_ids": np.zeros(T, np.int32)}
    image_mask = np.ones((CHUNK, R), np.int32)
    image_mask[1, -2:] = 0
    chunk = {"features": rng.randn(CHUNK, R, cfg.v_feature_size).astype(np.float32),
             "spatials": rng.rand(CHUNK, R, 5).astype(np.float32), "image_mask": image_mask}
    return caption, chunk


def _score_args(caption, chunk, text_batch, to=np.asarray):
    def text(k):
        return to(np.ascontiguousarray(np.broadcast_to(caption[k], (text_batch, T))))

    return (text("question"), to(chunk["features"]), to(chunk["spatials"]), text("input_mask"),
            text("segment_ids"), to(chunk["image_mask"]))


@pytest.mark.parametrize("mode", ["vil_logit_fast", "vil_logit", "alignment"])
def test_scorers_match_jax(tiny_config, mode):
    """One caption against a chunk of four images (one with padded
    regions): the port's scores within 1e-4 of the JAX scorer's; with
    ``fast_mode`` the caption goes in at batch 1 on both sides."""
    from vilbert_tpu.eval import retrieval as jax_retrieval
    from vilbert_tpu.models.vilbert import (
        ViLBERTForPretraining as JaxPretraining,
        ViLBERTForVLTasks as JaxTasks,
    )
    from vilbert_tpu_torch.core.weights import flax_from_state_dict
    from vilbert_tpu_torch.eval import retrieval
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks

    fast = mode == "vil_logit_fast"
    cfg = tiny_config.replace(fast_mode=fast)
    caption, chunk = _caption_and_chunk(cfg)
    if mode == "alignment":
        model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(2))
        want_fn = jax_retrieval.make_alignment_scorer(
            JaxPretraining(cfg), flax_from_state_dict(model.state_dict()))
        got_fn = retrieval.make_alignment_scorer(model)
    else:
        model = ViLBERTForVLTasks(cfg, num_labels=13, generator=torch.Generator().manual_seed(2))
        want_fn = jax_retrieval.make_vil_logit_scorer(
            JaxTasks(cfg, num_labels=13), flax_from_state_dict(model.state_dict()))
        got_fn = retrieval.make_vil_logit_scorer(model)
    text_batch = 1 if fast else CHUNK
    want = np.asarray(want_fn(*_score_args(caption, chunk, text_batch)))
    got = got_fn(*_score_args(caption, chunk, text_batch, to=torch.from_numpy))
    assert got.shape == want.shape == (CHUNK,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert np.ptp(want) > 0  # the images score differently


def test_evaluate_retrieval_loops_chunks_outside(tiny_config):
    """Chunks outer, captions inner (one chunk resident at a time); the
    metrics equal the JAX evaluate_retrieval's over the same scorer."""
    from vilbert_tpu.eval.retrieval import evaluate_retrieval as jax_evaluate
    from vilbert_tpu_torch.eval.retrieval import evaluate_retrieval

    rng = np.random.RandomState(4)
    pool = {"features": rng.randn(8, R, 3).astype(np.float32),
            "spatials": rng.rand(8, R, 5).astype(np.float32),
            "image_mask": np.ones((8, R), np.int32)}
    captions = [{"question": rng.randint(1, 50, T).astype(np.int32),
                 "input_mask": np.ones(T, np.int32), "segment_ids": np.zeros(T, np.int32),
                 "target_index": i % 8} for i in range(10)]
    calls = []

    def scorer(q, feats, spats, im, sg, imask):  # any deterministic score
        calls.append((int(np.asarray(feats)[0, 0, 0] * 1e6), int(np.asarray(q)[0, 0])))
        return (np.asarray(feats)[:, :, 0].sum(-1) * np.asarray(q)[0, 0] % 7).astype(np.float32)

    def torch_scorer(*args):
        return torch.from_numpy(scorer(*args))

    got = evaluate_retrieval(torch_scorer, captions, pool, chunk=4, fast_mode=True,
                             device="cpu")
    port_calls, calls[:] = list(calls), []
    want = jax_evaluate(scorer, iter(captions), pool, chunk=4, fast_mode=True)
    assert got == want
    # the port: all captions on chunk 0, then all on chunk 1
    assert [c[0] for c in port_calls] == [port_calls[0][0]] * 10 + [port_calls[10][0]] * 10
    assert sorted(port_calls) == sorted(calls)
    with pytest.raises(AssertionError, match="multiple of chunk"):
        evaluate_retrieval(torch_scorer, captions, pool, chunk=3, device="cpu")


def _jax_npz(tmp_path, cfg_path, model_cls):
    """Weights the JAX package initialises and saves (``save_params``)."""
    from vilbert_tpu.core.checkpoint import save_params
    from vilbert_tpu.core.config import ModelConfig

    cfg = ModelConfig.from_json_file(str(cfg_path))
    params = model_cls(cfg).init(jax.random.PRNGKey(1), np.zeros((2, 5), np.int32),
                                 np.zeros((2, 3, cfg.v_feature_size), np.float32),
                                 np.zeros((2, 3, 5), np.float32))["params"]
    path = str(tmp_path / f"{model_cls.__name__}.npz")
    save_params(path, params)
    return path


@pytest.mark.parametrize("flags", [[], ["--fast_mode"], ["--zero_shot"]])
def test_cli_metrics_equal_the_jax_clis(tmp_path, flags):
    """--synthetic (8 images, 40 captions, chunk 4) with a JAX-saved .npz:
    the port's metrics JSON equals the JAX CLI's (its plain mode: fast_mode
    gives the same ranks)."""
    from vilbert_tpu.cli.eval_retrieval import main as jax_main
    from vilbert_tpu.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks
    from vilbert_tpu_torch.cli.eval_retrieval import main

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    zero_shot = "--zero_shot" in flags
    params = _jax_npz(tmp_path, cfg,
                      ViLBERTForPretraining if zero_shot else ViLBERTForVLTasks)
    common = ["--synthetic", "--config", str(cfg), "--params", params]
    jax_main([*common, *(["--zero_shot"] if zero_shot else []),
              "--output", str(tmp_path / "jax.json")])
    got = main([*common, *flags, "--device", "cpu", "--output", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want == got
    assert want["num_captions"] == 40 and want["pool_size"] == 8


@pytest.mark.parametrize("flags", [[], ["--zero_shot"], ["--zero_shot", "--fast_mode"]])
def test_baseline_cli_metrics_equal_the_jax_clis(tmp_path, flags):
    """--baseline --synthetic with a JAX-saved single-stream .npz
    (``BaseBertForVLTasks``, or ``BaseBertForPretraining`` zero-shot, where
    both CLIs ignore --fast_mode): the port's metrics JSON equals the JAX
    CLI's. Every weight matrix and table of the JAX initialisation is scaled
    by 10: at the initialiser's 0.02 the single stream's pooled [CLS] row
    barely sees the image, and two images' scores tie within 1e-8, where
    fp32 rounding decides the rank."""
    from vilbert_tpu.cli.eval_retrieval import main as jax_main
    from vilbert_tpu.core.checkpoint import load_params, save_params
    from vilbert_tpu.core.importer import _flatten, _unflatten
    from vilbert_tpu.models.basebert import BaseBertForPretraining, BaseBertForVLTasks
    from vilbert_tpu_torch.cli.eval_retrieval import main

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    params = _jax_npz(tmp_path, cfg, BaseBertForPretraining if "--zero_shot" in flags
                      else BaseBertForVLTasks)
    save_params(params, _unflatten({k: v * 10 if k.endswith(("kernel", "embedding")) else v
                                    for k, v in _flatten(load_params(params)).items()}))
    common = ["--synthetic", "--baseline", "--config", str(cfg), "--params", params, *flags]
    jax_main([*common, "--output", str(tmp_path / "jax.json")])
    got = main([*common, "--device", "cpu", "--output", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want == got
    assert want["num_captions"] == 40 and want["pool_size"] == 8


def test_baseline_fast_mode_fails_in_both_clis(tmp_path):
    """Fine-tuned --baseline --fast_mode: the JAX CLI fails where it
    concatenates the caption at batch 1 with the image chunk; the port
    refuses the flags up front."""
    from vilbert_tpu.cli.eval_retrieval import main as jax_main
    from vilbert_tpu_torch.cli.eval_retrieval import main

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    argv = ["--synthetic", "--baseline", "--fast_mode", "--config", str(cfg),
            "--output", str(tmp_path / "r.json")]
    with pytest.raises(TypeError, match="concatenate"):
        jax_main(argv)
    with pytest.raises(ValueError, match="--baseline --fast_mode"):
        main([*argv, "--device", "cpu"])


def _demo_lines(tmp_path, monkeypatch, flags=()):
    """(JAX lines, port lines) of the root demo.py and cli/demo.py --device
    cpu on the same .npz and question."""
    import importlib.util

    from vilbert_tpu.models.vilbert import ViLBERTForVLTasks
    from vilbert_tpu_torch.cli import demo

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    argv = ["--synthetic", "--config", str(cfg), "--params",
            _jax_npz(tmp_path, cfg, ViLBERTForVLTasks), "--question", "what color is the couch?",
            *flags]
    spec = importlib.util.spec_from_file_location("jax_demo", REPO / "demo.py")
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    monkeypatch.setattr(sys, "argv", ["demo.py", *argv])
    want, got = io.StringIO(), io.StringIO()
    with redirect_stdout(want):
        jax_demo.main()
    with redirect_stdout(got):
        demo.main([*argv, "--device", "cpu"])
    return want.getvalue().splitlines(), got.getvalue().splitlines()


def _assert_same_demo(want, got):
    assert len(got) == len(want) == 6
    assert got[:3] == want[:3]
    assert got[4].split("(")[0] == want[4].split("(")[0]  # the grounded row
    number = re.compile(r"-?\d+\.\d+")
    for g, w in zip(got[3:], want[3:]):
        for a, b in zip(number.findall(g), number.findall(w)):
            assert abs(float(a) - float(b)) <= 10.0 ** -len(b.split(".")[1]), (g, w)


def test_demo_prints_the_jax_demos_lines(tmp_path, monkeypatch):
    """cli/demo.py --device cpu and the root demo.py, the same .npz and
    question: the same argmax lines (VQA, GQA, grounded row), the scores
    within the last printed digit."""
    _assert_same_demo(*_demo_lines(tmp_path, monkeypatch))


def test_demo_int8_prints_the_jax_demos_lines(tmp_path, monkeypatch):
    """``--int8`` in both demos (dynamic int8 at B = 1, where every int8
    product of the port is padded to torch._int_mm's shape rules on a
    card): the same lines as above, from the JAX demo's int8 forward."""
    _assert_same_demo(*_demo_lines(tmp_path, monkeypatch, ["--int8"]))
