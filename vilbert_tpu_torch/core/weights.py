"""Weights in and out of the port: flax param trees, ``.npz`` and ``.bin``.

Counterpart of ``vilbert_tpu/core/checkpoint.py::load_params`` /
``load_pretrained_torch``. The port's parameter names ARE the reference
torch ``state_dict`` names, so one mapping serves everything:
``core.importer._to_flax_key`` names the flax path of each port
parameter and ``_needs_transpose`` says which are Linear weights ([out, in]
in torch, [in, out] as a flax kernel). Embedding tables and LayerNorm
parameters are not transposed. The reference's tied LM decoder and dead
``q_dense`` weights have no port parameter: the importer skips them.

- ``flax_from_state_dict`` / ``state_dict_from_flax``: exact round trip
  between a port ``state_dict`` and a flax params tree of numpy arrays,
  each parameter in its own dtype (bf16 as ``ml_dtypes.bfloat16``, as flax
  keeps ``param_dtype="bfloat16"`` params; a 2-byte void array, which is
  what ``np.load`` gives back for one, reads as bf16);
- ``load_params_npz`` / ``save_params_npz``: a flat ``.npz`` keyed by flax
  path, as ``vilbert_tpu.core.checkpoint.save_params`` writes it and
  ``load_params`` reads it, so a checkpoint moves between the packages;
- ``load_weights``: ``.npz`` or a reference ``.bin`` checkpoint into a model
  (the ``.bin`` path goes through the importer's key migration: ``module.``
  and ``bert.`` prefixes, gamma/beta, weight-norm folding).

- ``quant_from_model`` / ``load_quant``: the static-int8 sites' calibrated
  ranges (``act_amax`` buffers, not in the ``state_dict``) out as, and in
  from, flax's ``quant`` collection, so that a calibration done in either
  package drives the other;
- ``flax_path``: the flax path of a port name that is no parameter (a
  site's ``act_amax``, a ``visualization`` map: flax's ``intermediates``).

``family`` names the model family the parameter names belong to:
``"vilbert"`` (the two-stream models) or ``"basebert"`` (the single-stream
baseline, ``models.basebert``), whose reference names map onto other flax
paths (``bert.encoder.layer.N`` to ``bert.layer_N``, ``cls.predictions``
to ``predictions``, ...: the importer's ``_BASEBERT_REWRITES``). The
functions that take a model read it from the model class's ``family``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

from vilbert_tpu_torch.core.importer import (
    _flatten,
    _needs_transpose,
    _to_flax_key,
    _unflatten,
    import_torch_state_dict,
    load_torch_checkpoint,
)
from vilbert_tpu_torch.ops.quant import static_sites

logger = logging.getLogger(__name__)


FAMILIES = ("vilbert", "basebert")


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")


def _to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own dtype (bf16: ml_dtypes')."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16, as flax's bf16 params are

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor of its own dtype: bf16 (ml_dtypes', or the
    2-byte void that ``np.load`` returns for it) as torch.bfloat16."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(arr)


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                         family: str = "vilbert") -> Dict[str, Any]:
    """Port ``state_dict`` -> nested flax params tree of numpy arrays, each
    in its parameter's dtype."""
    _check_family(family)
    flat = {}
    for key, tensor in state_dict.items():
        fkey = _to_flax_key(key, family)
        if fkey is None:
            continue
        arr = _to_numpy(tensor)
        flat[fkey] = arr.T.copy() if _needs_transpose(key, family) else arr
    return _unflatten(flat)


def state_dict_from_flax(
    params: Mapping[str, Any], keys: Iterable[str], family: str = "vilbert"
) -> Dict[str, torch.Tensor]:
    """Flax params tree -> ``state_dict`` over the port parameter names
    ``keys`` (``model.state_dict().keys()``), each tensor in its leaf's
    dtype. Every key must be provided and every flax leaf used: a mismatch
    raises ValueError naming the keys."""
    _check_family(family)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    by_flax = {_to_flax_key(k, family): k for k in keys}
    missing = sorted(set(by_flax) - set(flat))
    unused = sorted(set(flat) - set(by_flax))
    if missing or unused:
        raise ValueError(
            f"flax params do not match the model: missing {missing[:10]}, "
            f"unused {unused[:10]}"
        )
    out = {}
    for fkey, key in by_flax.items():
        arr = flat[fkey].T if _needs_transpose(key, family) else flat[fkey]
        out[key] = _to_tensor(arr)
    return out


def flax_path(name: str, family: str = "vilbert") -> str:
    """Dotted flax path of ``<port module path>.<leaf>`` where the leaf is
    no parameter: the module's path maps as its parameters' do."""
    _check_family(family)
    module, leaf = name.rsplit(".", 1)
    return _to_flax_key(f"{module}.bias", family)[: -len("bias")] + leaf


def quant_from_model(model: nn.Module) -> Dict[str, Any]:
    """The calibrated ``act_amax`` of ``model``'s static-int8 sites as a
    flax ``quant`` tree of numpy [in] vectors (sites never calibrated are
    left out, as a flax calibration pass creates only the sites it ran)."""
    return _unflatten({
        flax_path(f"{name}.act_amax", model.family): m.act_amax.detach().cpu().numpy().copy()
        for name, m in static_sites(model).items() if m.calibrated})


def load_quant(model: nn.Module, quant: Mapping[str, Any]) -> None:
    """A flax ``quant`` tree into ``model``'s static-int8 sites, which then
    count as calibrated. Sites the tree leaves out stay as they were (a
    calibration of some heads covers those heads' sites); a leaf that names
    no site raises ValueError."""
    sites = static_sites(model)
    by_flax = {flax_path(f"{name}.act_amax", model.family): name for name in sites}
    flat = {k: np.asarray(v) for k, v in _flatten(quant).items()}
    unused = sorted(set(flat) - set(by_flax))
    if unused:
        raise ValueError(f"quant leaves that name no int8_static site: {unused[:10]}")
    for fkey, arr in flat.items():
        m = sites[by_flax[fkey]]
        m.act_amax = torch.tensor(arr, dtype=torch.float32, device=m.act_amax.device)
        m.calibrated = True


def load_params_npz(path: str) -> Dict[str, Any]:
    """Flat ``.npz`` keyed by dotted flax path -> nested params tree."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def save_params_npz(path: str, model: nn.Module) -> None:
    """``model``'s weights -> flat ``.npz`` keyed by dotted flax path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(flax_from_state_dict(model.state_dict(), model.family)))


def load_weights(model: nn.Module, path: str) -> None:
    """Load ``.npz`` (flax paths) or a reference torch ``.bin`` into ``model``."""
    family = model.family
    keys = list(model.state_dict().keys())
    if path.endswith(".npz"):
        params = load_params_npz(path)
    else:
        target = flax_from_state_dict(model.state_dict(), family)
        params, report = import_torch_state_dict(load_torch_checkpoint(path), target,
                                                 family=family)
        logger.info("loaded %d params from %s (%d kept at init, %d without destination)",
                    len(report.loaded), path, len(report.missing), len(report.unexpected))
    model.load_state_dict(state_dict_from_flax(params, keys, family))
