"""Full-state checkpoints: save, keep the last few, restore.

Counterpart of ``vilbert_tpu/core/checkpoint.py::CheckpointManager`` (orbax,
which needs JAX) on ``torch.save`` / ``torch.load(weights_only=True)``. A
checkpoint is one directory a step, ``<directory>/<step>/``, holding

- ``state.pt``: a nested dict of tensors and numbers, the caller's training
  state (the step, the parameters under the port's ``state_dict`` names,
  the optimizer's ``state_dict``: count and moments for AdamW, each label's
  count and moments for RAdam);
- ``host.json``: optional host state (controllers, schedule, logger, epoch).

A step directory is written under a temporary name and renamed when
complete, and only the newest ``max_to_keep`` are kept. ``restore`` reads a
step into the structure of a template: a tensor whose saved dtype differs
from the template's (``--bf16_adam_state`` toggled between save and resume)
is converted, as the JAX package converts it, and a warning names the
groups converted. Weights-only files stay in ``core/weights.py``
(``save_params_npz`` / ``load_params_npz``). In a data-parallel run
(``mesh``) rank 0 writes and every rank waits at a barrier until the step
is complete; every rank reads on restore.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
HOST_FILE = "host.json"


class CheckpointManager:
    """Step directories under ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, Any], *,
             host_state: Optional[Mapping[str, Any]] = None) -> str:
        """Write ``state`` (and ``host_state``) as step ``step``; returns its
        directory. Synchronous: the files are complete on return (on every
        rank of the mesh, of which rank 0 writes)."""
        final = os.path.join(self.directory, str(int(step)))
        if self.mesh is not None and not self.mesh.is_primary:
            self.mesh.barrier()
            return final
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if host_state is not None:
            with open(os.path.join(tmp, HOST_FILE), "w") as f:
                json.dump(host_state, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        if self.mesh is not None:
            self.mesh.barrier()
        return final

    def restore(self, template: Mapping[str, Any], *, step: Optional[int] = None
                ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int]:
        """(state, host state or None, step) of ``step`` (the latest when
        None). The state has the template's structure, each tensor on the
        template tensor's device and in its dtype."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, str(step))
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        converted: Dict[str, List[str]] = {}
        state = _conform(template, saved, "", converted)
        if converted:
            logger.warning("checkpoint %s: converted %s", path, "; ".join(
                f"{group} ({len(v)} tensors, {v[0]})" for group, v in converted.items()))
        host = None
        if os.path.isfile(os.path.join(path, HOST_FILE)):
            with open(os.path.join(path, HOST_FILE)) as f:
                host = json.load(f)
        return state, host, step


def _conform(template: Any, saved: Any, path: str, converted: Dict[str, List[str]]) -> Any:
    """``saved`` in the structure, dtypes and devices of ``template``;
    ``converted`` collects "<saved> -> <template>" by parent path."""
    if isinstance(template, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(template):
            have = set(saved) if isinstance(saved, Mapping) else set()
            raise ValueError(f"checkpoint does not match the state at {path or '<root>'}: "
                             f"missing {sorted(set(template) - have)[:5]}, "
                             f"unexpected {sorted(have - set(template))[:5]}")
        return {k: _conform(template[k], saved[k], f"{path}.{k}" if path else str(k), converted)
                for k in template}
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint {path}: {getattr(saved, 'shape', saved)} saved, "
                             f"{tuple(template.shape)} expected")
        if saved.dtype != template.dtype:
            converted.setdefault(path.rsplit(".", 1)[0], []).append(
                f"{saved.dtype} -> {template.dtype}".replace("torch.", ""))
        return saved.to(device=template.device, dtype=template.dtype)
    return type(template)(saved) if isinstance(template, (int, float)) else saved
