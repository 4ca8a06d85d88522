"""``ModelConfig.param_dtype`` in the PyTorch port against the JAX package.

The JAX modules create every parameter in ``cfg.param_dtype`` (each
``param``, ``nn.Dense``, ``nn.Embed`` and LayerNorm); the port's modules
create theirs in the same dtype (``models.layers.param_dtype``), and the
weight bridge keeps each parameter's dtype both ways. On the CPU, on
2-layer configs of both model families, the two-stream one cut from
``tiny_config`` and the single-stream baseline from
``configs/bert_base_baseline.json``.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from vilbert_tpu.core.importer import _flatten, _to_flax_key

REPO = Path(__file__).resolve().parents[1]
B, T, R = 3, 7, 5

#: model class -> (package module, the parameter names' family)
KINDS = {
    "ViLBERTForVLTasks": ("vilbert", "vilbert"),
    "ViLBERTForPretraining": ("vilbert", "vilbert"),
    "BaseBertForVLTasks": ("basebert", "basebert"),
    "BaseBertForPretraining": ("basebert", "basebert"),
}


def _cfg(tiny_config, kind, param_dtype):
    """A 2-layer config of ``kind``'s family in fp32 compute (the two-stream
    task model with task tokens)."""
    from vilbert_tpu.core.config import ModelConfig

    if KINDS[kind][0] == "basebert":
        return ModelConfig.from_json_file(
            str(REPO / "configs" / "bert_base_baseline.json"), hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=256,
            t_biattention_id=(0, 1), compute_dtype="float32", hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, param_dtype=param_dtype)
    return tiny_config.replace(num_hidden_layers=2, t_biattention_id=(0, 1),
                               task_specific_tokens=kind == "ViLBERTForVLTasks",
                               param_dtype=param_dtype)


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    am = np.ones((B, T), np.int32)
    am[:, -2:] = 0
    im = np.ones((B, R), np.int32)
    im[1, -2:] = 0
    return dict(
        input_txt=rng.randint(1, cfg.vocab_size, (B, T)).astype(np.int32),
        input_imgs=rng.randn(B, R, cfg.v_feature_size).astype(np.float32),
        image_loc=rng.rand(B, R, cfg.num_locs).astype(np.float32),
        token_type_ids=rng.randint(0, 2, (B, T)).astype(np.int32),
        attention_mask=am,
        image_attention_mask=im,
    )


def _port(kind, cfg, seed=0):
    import importlib

    module = importlib.import_module(f"vilbert_tpu_torch.models.{KINDS[kind][0]}")
    return getattr(module, kind)(cfg, generator=torch.Generator().manual_seed(seed)).eval()


def _jax(kind, cfg):
    import importlib

    return getattr(importlib.import_module(f"vilbert_tpu.models.{KINDS[kind][0]}"), kind)(cfg)


def _bf16_bound(ref) -> float:
    """One bf16 rounding of the largest output (as tests/test_torch_dropout.py)."""
    top = float(np.abs(ref).max())
    return 2.0 ** -7 * top + 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_parameters_take_the_dtypes_of_the_flax_init(tiny_config, kind, param_dtype):
    """Name for name, every port parameter has the dtype of the flax init's
    leaf it maps to, and the two trees hold the same leaves."""
    cfg = _cfg(tiny_config, kind, param_dtype)
    family = KINDS[kind][1]
    x = _inputs(cfg)
    extra = {"task_ids": np.zeros((B, 1), np.int32)} if cfg.task_specific_tokens else {}
    want = {path: str(leaf.dtype) for path, leaf in _flatten(jax.eval_shape(
        functools.partial(_jax(kind, cfg).init, **extra), jax.random.PRNGKey(0),
        x["input_txt"], x["input_imgs"], x["image_loc"])["params"]).items()}
    got = {_to_flax_key(name, family): str(t.dtype).removeprefix("torch.")
           for name, t in _port(kind, cfg).state_dict().items()}
    assert got == want
    assert set(got.values()) == {param_dtype}


@pytest.mark.parametrize("kind", ["ViLBERTForVLTasks", "BaseBertForVLTasks"])
def test_bf16_parameters_round_trip_through_flax_and_npz(tiny_config, kind, tmp_path):
    """A bf16 state_dict -> flax tree (ml_dtypes bf16 leaves, as flax keeps
    them) -> state_dict, and through a saved ``.npz`` (whose bf16 leaves
    ``np.load`` returns as 2-byte voids), bit for bit and in bf16."""
    from vilbert_tpu_torch.core.weights import (
        flax_from_state_dict,
        load_weights,
        save_params_npz,
        state_dict_from_flax,
    )

    cfg = _cfg(tiny_config, kind, "bfloat16")
    family = KINDS[kind][1]
    model = _port(kind, cfg)
    want = model.state_dict()
    tree = flax_from_state_dict(want, family)
    assert {str(np.asarray(v).dtype) for v in _flatten(tree).values()} == {"bfloat16"}
    back = state_dict_from_flax(tree, want.keys(), family)
    save_params_npz(str(tmp_path / "p.npz"), model)
    fresh = _port(kind, cfg, seed=3)
    load_weights(fresh, str(tmp_path / "p.npz"))
    for name, t in want.items():
        for other in (back[name], fresh.state_dict()[name]):
            assert other.dtype == torch.bfloat16 and torch.equal(other, t), name


@pytest.mark.parametrize("kind", ["ViLBERTForVLTasks", "BaseBertForVLTasks"])
def test_bf16_parameters_forward_matches_flax(tiny_config, kind):
    """Every head of a forward from the same bf16 weights (fp32 compute)
    within one bf16 rounding of the largest output of the flax apply through
    the Pallas kernels (interpret mode). Both round the embedding sum and
    the LayerNorms' outputs to the bf16 of their weights, at places that
    differ by the order of the sums."""
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    cfg = _cfg(tiny_config, kind, "bfloat16")
    model = _port(kind, cfg, seed=4)
    params = flax_from_state_dict(model.state_dict(), KINDS[kind][1])
    x = _inputs(cfg, seed=4)
    if kind == "ViLBERTForVLTasks":
        x["task_ids"] = np.array([[1], [3], [5]], np.int32)
    jax_cfg = cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)
    want = jax.jit(functools.partial(_jax(kind, jax_cfg).apply, heads=None))(
        {"params": params}, **x)
    with torch.inference_mode():
        got = model(**{k: torch.from_numpy(v) for k, v in x.items()})
    compared = 0
    for name in want._fields:
        w = getattr(want, name)
        if w is None or getattr(got, name) is None:
            assert (w is None) == (getattr(got, name) is None), name
            continue
        w = np.asarray(w, np.float32)
        err = float(np.abs(getattr(got, name).float().numpy() - w).max())
        assert err <= _bf16_bound(w), (name, err, _bf16_bound(w))
        compared += 1
    assert compared >= 4
