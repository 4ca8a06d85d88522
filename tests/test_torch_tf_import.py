"""The port's TF checkpoint import (``core/tf_import.py``) against the JAX one.

``tests/test_tf_import.py``'s name mapping and synthetic variables, and a
TF variable for every text-stream parameter of ``tiny_config``, go through
``vilbert_tpu.core.tf_import.import_tf_weights`` and the port's
``load_tf_weights`` from the same initial weights: the port's parameters
equal the JAX result leaf for leaf (through ``state_dict_from_flax``), with
the same report. ``load_tf_checkpoint`` reads a TF-1 checkpoint written
here (where tensorflow is installed; it is imported in a subprocess) and
raises ImportError without tensorflow.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

NAMES = [
    "bert/embeddings/word_embeddings",
    "bert/embeddings/LayerNorm/gamma",
    "bert/encoder/layer_3/attention/self/query/kernel",
    "bert/encoder/layer_0/attention/output/dense/bias",
    "bert/encoder/layer_11/intermediate/dense/kernel",
    "bert/encoder/layer_11/output/LayerNorm/beta",
    "cls/predictions/transform/dense/kernel",
    "cls/predictions/output_bias",
    "bert/pooler/dense/kernel",
    "cls/seq_relationship/output_weights",
    "bert/encoder/layer_0/attention/self/query/kernel/adam_m",
    "global_step",
]


@pytest.mark.parametrize("name", NAMES)
def test_tf_name_mapping_is_the_jax_one(name):
    from vilbert_tpu.core.tf_import import tf_name_to_flax as jax_map
    from vilbert_tpu_torch.core.tf_import import tf_name_to_flax

    assert tf_name_to_flax(name) == jax_map(name)


def _text_stream_variables(cfg, rng):
    """A TF variable for every text-stream parameter of the two-stream model
    (google-research BERT names), plus ones without a destination."""
    out = {
        "bert/embeddings/word_embeddings": (cfg.vocab_size, cfg.hidden_size),
        "bert/embeddings/position_embeddings": (cfg.max_position_embeddings, cfg.hidden_size),
        "bert/embeddings/token_type_embeddings": (cfg.type_vocab_size, cfg.hidden_size),
        "bert/embeddings/LayerNorm/gamma": (cfg.hidden_size,),
        "bert/embeddings/LayerNorm/beta": (cfg.hidden_size,),
        "cls/predictions/transform/dense/kernel": (cfg.hidden_size, cfg.hidden_size),
        "cls/predictions/transform/dense/bias": (cfg.hidden_size,),
        "cls/predictions/transform/LayerNorm/gamma": (cfg.hidden_size,),
        "cls/predictions/transform/LayerNorm/beta": (cfg.hidden_size,),
        "cls/predictions/output_bias": (cfg.vocab_size,),
        "bert/pooler/dense/kernel": (cfg.hidden_size, cfg.hidden_size),
        "cls/seq_relationship/output_weights": (2, cfg.hidden_size),
        "adam_v/whatever": (3,),
        "global_step": (),
    }
    h, i = cfg.hidden_size, cfg.intermediate_size
    for n in range(cfg.num_hidden_layers):
        p = f"bert/encoder/layer_{n}/"
        for m in ("query", "key", "value"):
            out[f"{p}attention/self/{m}/kernel"] = (h, h)
            out[f"{p}attention/self/{m}/bias"] = (h,)
        out[f"{p}attention/output/dense/kernel"] = (h, h)
        out[f"{p}attention/output/dense/bias"] = (h,)
        out[f"{p}attention/output/LayerNorm/gamma"] = (h,)
        out[f"{p}attention/output/LayerNorm/beta"] = (h,)
        out[f"{p}intermediate/dense/kernel"] = (h, i)
        out[f"{p}intermediate/dense/bias"] = (i,)
        out[f"{p}output/dense/kernel"] = (i, h)
        out[f"{p}output/dense/bias"] = (h,)
        out[f"{p}output/LayerNorm/gamma"] = (h,)
        out[f"{p}output/LayerNorm/beta"] = (h,)
    return {k: np.asarray(rng.randn(*s), np.float32) for k, s in out.items()}


@pytest.mark.parametrize("which", ["test_tf_import", "text_stream"])
def test_import_equals_jax_leaf_for_leaf(tiny_config, which):
    from vilbert_tpu.core.tf_import import import_tf_weights
    from vilbert_tpu_torch.core.tf_import import load_tf_weights
    from vilbert_tpu_torch.core.weights import flax_from_state_dict, state_dict_from_flax
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    cfg = tiny_config
    model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(0))
    keys = list(model.state_dict())
    init = flax_from_state_dict(model.state_dict())
    rng = np.random.RandomState(0)
    if which == "test_tf_import":  # tests/test_tf_import.py's variables
        variables = {
            "bert/embeddings/word_embeddings":
                rng.randn(cfg.vocab_size, cfg.hidden_size).astype(np.float32),
            "bert/encoder/layer_0/attention/self/query/kernel":
                rng.randn(cfg.hidden_size, cfg.hidden_size).astype(np.float32),
            "bert/pooler/dense/kernel": rng.randn(4, 4).astype(np.float32),
            "adam_v/whatever": rng.randn(3).astype(np.float32),
        }
    else:
        variables = _text_stream_variables(cfg, rng)
    want_params, want_report = import_tf_weights(variables, init)
    report = load_tf_weights(model, variables)
    assert report == want_report
    assert len(report.loaded) == (2 if which == "test_tf_import" else
                                  10 + 16 * cfg.num_hidden_layers)
    want = state_dict_from_flax(want_params, keys)
    got = model.state_dict()
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the vision stream and the poolers stay at init
    sd = state_dict_from_flax(init, keys)
    assert torch.equal(got["bert.t_pooler.dense.weight"], sd["bert.t_pooler.dense.weight"])


def test_shape_mismatch_raises(tiny_config):
    from vilbert_tpu_torch.core.tf_import import load_tf_weights
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    model = ViLBERTForPretraining(tiny_config)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_tf_weights(model, {"bert/embeddings/word_embeddings": np.zeros((3, 3), np.float32)})


_WRITE_AND_READ = """
import sys
import numpy as np
import tensorflow as tf
from vilbert_tpu_torch.core.tf_import import load_tf_checkpoint

src, path, out = sys.argv[1:4]
with np.load(src) as z:
    variables = {k.replace("|", "/"): z[k] for k in z.files}
with tf.Graph().as_default():
    tf_vars = {n: tf.compat.v1.Variable(v, name=n) for n, v in variables.items()}
    saver = tf.compat.v1.train.Saver(tf_vars)
    with tf.compat.v1.Session() as sess:
        sess.run(tf.compat.v1.global_variables_initializer())
        saver.save(sess, path)
read = load_tf_checkpoint(path)
np.savez(out, **{k.replace("/", "|"): v for k, v in read.items()})
print("TF_OK")
"""


@pytest.mark.skipif(importlib.util.find_spec("tensorflow") is None,
                    reason="tensorflow is not installed")
def test_load_tf_checkpoint_reads_every_variable(tmp_path, tiny_config):
    """A TF-1 checkpoint of the text-stream variables, written with
    tensorflow, reads back as the same arrays (in a subprocess: tensorflow
    stays out of this one)."""
    variables = _text_stream_variables(tiny_config, np.random.RandomState(1))
    np.savez(tmp_path / "src.npz", **{k.replace("/", "|"): v for k, v in variables.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO), TF_CPP_MIN_LOG_LEVEL="3",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _WRITE_AND_READ, str(tmp_path / "src.npz"),
         str(tmp_path / "ckpt" / "model.ckpt"), str(tmp_path / "read.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "TF_OK" in proc.stdout, proc.stderr[-3000:]
    with np.load(tmp_path / "read.npz") as z:
        read = {k.replace("|", "/"): z[k] for k in z.files}
    assert set(read) == set(variables)
    for k, v in variables.items():
        np.testing.assert_array_equal(read[k], v, err_msg=k)


def test_load_tf_checkpoint_without_tensorflow_raises(monkeypatch, tmp_path):
    from vilbert_tpu_torch.core.tf_import import load_tf_checkpoint

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tensorflow"):
        load_tf_checkpoint(str(tmp_path / "none"))
