"""PyTorch checkpoint → flax params importer.

The port's own copy of ``vilbert_tpu/core/importer.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Maps reference state_dict names (facebookresearch/vilbert-multi-task layout,
see vilbert/vilbert.py module tree) onto this package's flax param paths.
Replaces the reference's HF-style recursive loader with key migration
(vilbert/utils.py:831-1032): gamma/beta → weight/bias, missing/unexpected-key
reporting, optional ``bert.`` prefix handling.

Conventions:
- torch ``nn.Linear.weight`` is [out, in]; flax ``nn.Dense.kernel`` is
  [in, out] → transposed on import.
- the tied LM decoder weight (cls.predictions.decoder.weight) is skipped —
  our LM head reads the embedding table directly.
- the reference's dead ``biOutput.q_dense{1,2}`` weights (vilbert.py:834-842)
  are skipped.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: torch names to drop entirely (dead weights / tied weights)
_SKIP_PATTERNS = (
    re.compile(r"\.q_dense[12]\."),
    re.compile(r"cls\.predictions\.decoder\.weight$"),
    re.compile(r"position_ids$"),  # some HF exports store a buffer
)

#: ordered (pattern, replacement) rewrites from torch names to flax paths
_REWRITES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(p), r)
    for p, r in [
        (r"^module\.", ""),  # DDP prefix (train_tasks.py resume path)
        (r"\.gamma$", ".weight"),  # legacy TF-era names (utils.py:946-958)
        (r"\.beta$", ".bias"),
        (r"encoder\.layer\.(\d+)\.", r"encoder.layer_\1."),
        (r"encoder\.v_layer\.(\d+)\.", r"encoder.v_layer_\1."),
        (r"encoder\.c_layer\.(\d+)\.", r"encoder.c_layer_\1."),
        (r"\.attention\.self\.", ".attention_self."),
        (r"\.attention\.output\.", ".attention_output."),
        (r"\.v_intermediate\.dense\.", ".v_ffn.intermediate_dense."),
        (r"\.v_output\.dense\.", ".v_ffn.output_dense."),
        (r"\.v_output\.LayerNorm\.", ".v_ffn.LayerNorm."),
        (r"\.t_intermediate\.dense\.", ".t_ffn.intermediate_dense."),
        (r"\.t_output\.dense\.", ".t_ffn.output_dense."),
        (r"\.t_output\.LayerNorm\.", ".t_ffn.LayerNorm."),
        (r"\.intermediate\.dense\.", ".ffn.intermediate_dense."),
        (r"\.output\.dense\.", ".ffn.output_dense."),
        (r"\.output\.LayerNorm\.", ".ffn.LayerNorm."),
        (r"^vil_logit\.", "vil_logit_dense."),
        (r"^vil_tri_prediction\.", "vil_tri_dense."),
        (r"^vision_logit\.", "vision_logit_dense."),
        (r"^linguisic_logit\.", "linguisic_logit_dense."),
        (r"\.logit_fc\.0\.", ".dense1."),
        (r"\.logit_fc\.2\.", ".LayerNorm."),
        (r"\.logit_fc\.3\.", ".dense2."),
    ]
)

#: extra rewrites for the single-stream baseline (vilbert/basebert.py) whose
#: module names collide with different two-stream destinations
_BASEBERT_REWRITES: Tuple[Tuple[re.Pattern, str], ...] = tuple(
    (re.compile(p), r)
    for p, r in [
        (r"(^|\.)encoder\.layer\.(\d+)\.", r"\1layer_\2."),
        (r"(^|\.)pooler\.dense\.", r"\1pooler_dense."),
        (r"^cls\.predictions\.", "predictions."),
        (r"^cls\.seq_relationship\.", "seq_relationship."),
        (r"^cls\.imagePredictions\.transform\.", "image_transform."),
        (r"^cls\.imagePredictions\.decoder\.", "image_decoder."),
        (r"^vil_prediction\.main\.0\.", "vil_prediction_1."),
        (r"^vil_prediction\.main\.3\.", "vil_prediction_2."),
    ]
)

#: modules whose .weight is an embedding table (no transpose, leaf name
#: becomes "embedding")
_EMBED_RE = re.compile(
    r"(word_embeddings|position_embeddings|token_type_embeddings|task_embeddings)\.weight$"
)

#: leaf names that belong to LayerNorm (keep weight/bias naming, no transpose)
_LN_RE = re.compile(r"LayerNorm\d?\.(weight|bias)$")


class ImportReport(NamedTuple):
    loaded: List[str]
    missing: List[str]      # flax paths not provided by the checkpoint
    unexpected: List[str]   # torch keys with no destination


def _to_flax_key(torch_key: str, family: str = "vilbert") -> str | None:
    for pat in _SKIP_PATTERNS:
        if pat.search(torch_key):
            return None
    key = torch_key
    if family == "basebert":
        for pat, repl in _BASEBERT_REWRITES:
            key = pat.sub(repl, key)
    for pat, repl in _REWRITES:
        key = pat.sub(repl, key)
    if _EMBED_RE.search(key):
        key = key[: -len("weight")] + "embedding"
    elif key.endswith(".weight") and not _LN_RE.search(key):
        # Linear weight -> Dense kernel (transposed separately)
        key = key[: -len("weight")] + "kernel"
    return key


def _needs_transpose(torch_key: str, family: str = "vilbert") -> bool:
    if _EMBED_RE.search(torch_key) or _LN_RE.search(
        _to_flax_key(torch_key, family) or ""
    ):
        return False
    return torch_key.endswith(".weight")


def _fold_weight_norm(state_dict: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold torch weight_norm (weight_g, weight_v) pairs into plain weights.

    The reference basebert SimpleClassifier uses weight_norm(dim=None)
    (basebert.py:965-978): w = g * v / ||v||_F with scalar g.
    """
    out: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[: -len("weight_v")]
            g = np.asarray(state_dict[base + "weight_g"], np.float64)
            vv = np.asarray(v, np.float64)
            out[base + "weight"] = (g * vv / np.linalg.norm(vv)).astype(np.float32)
        else:
            out[k] = v
    return out


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def import_torch_state_dict(
    state_dict: Mapping[str, np.ndarray],
    target_params: Mapping[str, Any],
    *,
    dtype=np.float32,
    strict: bool = False,
    family: str = "vilbert",
) -> Tuple[Dict[str, Any], ImportReport]:
    """Convert a torch state_dict (numpy arrays) into a flax params dict.

    Args:
      state_dict: torch parameter name -> numpy array.
      target_params: the flax params (under the "params" collection) of the
        destination model, used for validation and to fill params the
        checkpoint doesn't provide (reference keeps them at init,
        utils.py:960-1016).
      strict: raise on any missing/unexpected key.

    Returns:
      (params, report). The tied LM decoder and dead q_dense weights are
      skipped by design and not reported as unexpected.
    """
    target_flat = _flatten(target_params)
    state_dict = _fold_weight_norm(state_dict)
    # Checkpoints for BertModel alone have no "bert." prefix while full-model
    # checkpoints do; detect by intersection (reference base_model_prefix
    # logic, utils.py:978-996).
    sample = [k for k in state_dict if not any(p.search(k) for p in _SKIP_PATTERNS)]
    mapped = {k: _to_flax_key(k, family) for k in sample}
    hits = sum(1 for v in mapped.values() if v in target_flat)
    add_prefix = ""
    strip_prefix = ""
    if hits < len(sample) // 2:
        if any(("bert." + (v or "")) in target_flat for v in mapped.values()):
            add_prefix = "bert."
        elif any(
            (v or "").startswith("bert.") and (v or "")[5:] in target_flat
            for v in mapped.values()
        ):
            strip_prefix = "bert."

    new_flat = dict(target_flat)
    loaded, unexpected = [], []
    for tkey, arr in state_dict.items():
        fkey = _to_flax_key(tkey, family)
        if fkey is None:
            continue
        if add_prefix:
            fkey = add_prefix + fkey
        elif strip_prefix and fkey.startswith(strip_prefix):
            fkey = fkey[len(strip_prefix):]
        if fkey not in target_flat:
            unexpected.append(tkey)
            continue
        # np.array (not asarray): own the memory. state_dicts produced via
        # torch_tensor.numpy() are VIEWS of live torch storage — without a
        # copy, later in-place torch updates would silently mutate the
        # imported params (and the views keep the torch model alive).
        value = np.array(arr, dtype=dtype)
        if _needs_transpose(tkey, family):
            value = value.T
        if value.shape != tuple(np.shape(target_flat[fkey])):
            raise ValueError(
                f"shape mismatch for {tkey} -> {fkey}: "
                f"{value.shape} vs {np.shape(target_flat[fkey])}"
            )
        new_flat[fkey] = value
        loaded.append(fkey)

    missing = sorted(set(target_flat) - set(loaded))
    report = ImportReport(loaded=sorted(loaded), missing=missing, unexpected=unexpected)
    if report.missing:
        logger.info("params not found in checkpoint (kept at init): %s",
                    report.missing[:20])
    if report.unexpected:
        logger.info("checkpoint keys without destination: %s", report.unexpected[:20])
    if strict and (report.missing or report.unexpected):
        raise ValueError(f"strict import failed: {report}")
    return _unflatten(new_flat), report


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a .bin/.pt torch checkpoint into numpy arrays (CPU, no grad)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v.detach().numpy() for k, v in sd.items() if hasattr(v, "detach")}
