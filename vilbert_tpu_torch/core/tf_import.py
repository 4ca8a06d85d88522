"""TF-checkpoint (original google-research BERT) weight import.

Counterpart of ``vilbert_tpu/core/tf_import.py`` (the reference
``load_tf_weights_in_bert``, vilbert/vilbert.py:48-108): seeds the TEXT
stream (embeddings, encoder layers, LM head) of the two-stream model from a
TF-1.x BERT checkpoint; the vision, co-attention and pooler parameters stay
at init, as when google's bert-base is loaded into the reference model.

``tf_name_to_flax`` and ``import_tf_weights`` are the JAX module's, over
flax params trees (TF dense kernels are already [in, out], as flax's);
``load_tf_weights`` puts the result into a port model through
``core.weights`` (``flax_from_state_dict`` / ``state_dict_from_flax``).
``load_tf_checkpoint`` needs tensorflow, imported when it is called.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from vilbert_tpu_torch.core.importer import ImportReport, _flatten, _unflatten

#: dotted-name rewrites applied after "/" -> "." conversion
_TF_REWRITES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(p), r)
    for p, r in [
        (r"embeddings\.word_embeddings$",
         "embeddings.word_embeddings.embedding"),
        (r"embeddings\.position_embeddings$",
         "embeddings.position_embeddings.embedding"),
        (r"embeddings\.token_type_embeddings$",
         "embeddings.token_type_embeddings.embedding"),
        (r"\.attention\.self\.", ".attention_self."),
        (r"\.attention\.output\.", ".attention_output."),
        (r"\.intermediate\.dense\.", ".ffn.intermediate_dense."),
        (r"\.output\.dense\.", ".ffn.output_dense."),
        (r"\.output\.LayerNorm\.", ".ffn.LayerNorm."),
        (r"predictions\.output_bias$", "predictions.bias"),
        (r"\.gamma$", ".weight"),
        (r"\.beta$", ".bias"),
    ]
)

#: TF vars with no destination here (optimizer slots, NSP head, TF pooler —
#: the two-stream text pooler has a different shape, hidden->bi_hidden)
_TF_SKIP = re.compile(
    r"(adam_v|adam_m|global_step|cls/seq_relationship|bert/pooler)"
)


def tf_name_to_flax(name: str) -> Optional[str]:
    if _TF_SKIP.search(name):
        return None
    out = name.replace("/", ".")
    for pat, repl in _TF_REWRITES:
        out = pat.sub(repl, out)
    return out


def import_tf_weights(
    variables: Mapping[str, np.ndarray],
    target_params: Mapping[str, Any],
) -> Tuple[Dict[str, Any], ImportReport]:
    """variables: TF var name -> numpy array (e.g. from
    ``tf.train.load_checkpoint(path)``)."""
    target_flat = _flatten(target_params)
    new_flat = dict(target_flat)
    loaded, unexpected = [], []
    for name, arr in variables.items():
        fkey = tf_name_to_flax(name)
        if fkey is None:
            continue
        if fkey not in target_flat:
            unexpected.append(name)
            continue
        value = np.asarray(arr, np.float32)
        if value.shape != tuple(np.shape(target_flat[fkey])):
            raise ValueError(
                f"shape mismatch {name} -> {fkey}: {value.shape} vs "
                f"{np.shape(target_flat[fkey])}"
            )
        new_flat[fkey] = value
        loaded.append(fkey)
    missing = sorted(set(target_flat) - set(loaded))
    return _unflatten(new_flat), ImportReport(sorted(loaded), missing, unexpected)


def load_tf_weights(model, variables: Mapping[str, np.ndarray]) -> ImportReport:
    """TF variables into a port model, in place: ``import_tf_weights`` over
    the model's flax params, then back into its parameters (each in its own
    dtype). Returns the report (loaded flax paths, those kept at init, TF
    names without a destination)."""
    from vilbert_tpu_torch.core.weights import flax_from_state_dict, state_dict_from_flax

    state = model.state_dict()
    params, report = import_tf_weights(variables, flax_from_state_dict(state, model.family))
    model.load_state_dict(state_dict_from_flax(params, list(state), model.family))
    return report


def load_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read every variable of a TF checkpoint into numpy arrays; needs
    tensorflow."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "load_tf_checkpoint reads TF checkpoints with tensorflow, which is not "
            "installed; convert the checkpoint's variables to numpy elsewhere and pass "
            "them to load_tf_weights") from e

    reader = tf.train.load_checkpoint(path)
    return {
        name: reader.get_tensor(name)
        for name in reader.get_variable_to_shape_map()
    }
