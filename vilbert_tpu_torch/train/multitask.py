"""12-in-1 multi-task training: task heads, batch reshapes and the trainer.

Counterpart of ``vilbert_tpu/train/multitask.py`` (reference train_tasks.py
+ task_utils.py):

- ``HEAD_FOR_TYPE``, ``MC_REGION_OFFSET`` and ``process_batch`` (the
  process-mode reshapes, task_utils.py:199-310);
- ``make_task_loss_fn`` / ``make_task_eval_fn`` over ``_task_logits``: one
  forward computing only the task's head, the ``VL-logit`` option reshape
  and the ``V-logit-mc`` gather past ``MC_REGION_OFFSET``;
- ``MultiTaskTrainer``: per-task loss scales lr_t / min lr
  (train_tasks.py:239-251), round-robin iterations gated by the stop
  controllers, one optimizer state shared by every task with each task's
  participation mask (``train.optim.task_update_mask``), and the
  reference's learning-rate quirks: the rate comes from the host once per
  iteration (``external_lr``), the first task trained in an iteration
  updates at lambda(i) and the others at ``mid_iteration(i)``, the epoch
  schedules change at epoch end.

The model runs in train mode (dropout at every site, seeds from the
trainer's ``torch.Generator``, see ``models.layers.set_dropout_generator``)
and, on a CUDA device, through the port's kernels. Each task's batches are
built and staged ``TrainConfig.prefetch_batches`` ahead on a thread of its
own (``data.prefetch.device_prefetch``; with ``grad_accum`` the thread
stacks the microbatches; 0 builds each between steps). ``model_family=
"basebert"`` (or ``"baseline"``) trains the single-stream baseline
``BaseBertForVLTasks``, with no participation masks, as the JAX trainer
does; it has no head for the GQA, VL-tri-classifier and NLVR2
(VL-binary-classifier over image pairs) tasks, which the JAX trainer fails
on at their first iteration and this one refuses at construction.

With a ``mesh`` (``parallel.mesh.Mesh``) each data row of ranks trains on
its loaders' shard of every batch: rank 0's weights and state are
broadcast at construction, the step averages the gradients over the data
axis, the per-task evaluation sums (loss, score, rows) over it so that the
stop controllers stay in lockstep (``vilbert_tpu/train/multitask.py:636-645``),
rank 0 writes the checkpoints and the logs. The state is replicated over a
model axis, as in the JAX trainer.

``in_batch_pairs`` makes the two-stream model score the B^2 (text, image)
pairs of a batch of B, which no task head's targets pair with: the task
loss and evaluation raise a ValueError naming it, where the JAX trainer
fails on the shapes (its model init or its loss; a batch of one row runs
in both). The single-stream baseline has no pairs, and trains.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig, TaskConfig, TrainConfig
from vilbert_tpu_torch.core.tracing import span
from vilbert_tpu_torch.data.prefetch import (
    compress_for_transfer,
    device_prefetch,
    to_device,
    to_tensors,
)
from vilbert_tpu_torch.models.layers import set_dropout_generator
from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks, set_pair_mesh
from vilbert_tpu_torch.parallel.distributed import sum_host
from vilbert_tpu_torch.parallel.train_step import batch_rows, make_train_step
from vilbert_tpu_torch.train.controllers import MultiTaskStopController
from vilbert_tpu_torch.train.losses import task_loss_and_score, task_loss_and_score_per_sample
from vilbert_tpu_torch.train.optim import build_optimizer, task_update_mask

logger = logging.getLogger(__name__)

#: head used per task type (reference task_utils.py:325-374)
HEAD_FOR_TYPE = {
    "VL-classifier": "vil_prediction",
    "VL-classifier-GQA": "vil_prediction_gqa",
    "VL-logit": "vil_logit",
    "V-logit": "vision_logit",
    "V-logit-mc": "vision_logit",
    "VL-binary-classifier": "vil_binary_prediction",
    "VL-tri-classifier": "vil_tri_prediction",
}

#: rows to skip before gathering multiple-choice options: the 100 detector
#: boxes + global row (reference task_utils.py:353 ``vision_logit[:, 101:]``)
MC_REGION_OFFSET = 101

#: task types the single-stream baseline has no head for: BaseBertForVLTasks
#: has neither the GQA nor the three-way head, and its binary head scores
#: each (text, image) row where NLVR2 scores image pairs
BASELINE_REFUSED_TYPES = ("VL-classifier-GQA", "VL-tri-classifier", "VL-binary-classifier")

#: batch entries the model never reads: the question ids, and the
#: co-attention mask, which the model accepts and ignores (the reference's
#: is inert too); they stay on the host
HOST_ONLY_KEYS = ("question_id", "co_attention_mask")


def process_batch(process: str, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Process-mode reshapes into a flat [B', ...] model batch."""
    b = dict(batch)
    feats, question = b["features"], b["question"]
    if process == "normal":
        return b
    if process in ("expand", "dialog"):
        # question [B, (rounds,) N, T] with one image per sample
        q = question.reshape(-1, question.shape[-1])
        n_opt = q.shape[0] // feats.shape[0]
        for k in ("features", "spatials", "image_mask"):
            b[k] = torch.repeat_interleave(b[k], n_opt, dim=0)
        b["question"] = q
        b["input_mask"] = b["input_mask"].reshape(-1, q.shape[-1])
        b["segment_ids"] = b["segment_ids"].reshape(-1, q.shape[-1])
        if b.get("target") is not None and b["target"].dim() > 1:
            b["target"] = b["target"].reshape(-1)
        return b
    if process == "retrieval":
        # every field carries its own [B, 4, ...] axis
        for k in ("features", "spatials", "image_mask", "question",
                  "input_mask", "segment_ids"):
            b[k] = b[k].reshape(-1, *b[k].shape[2:])
        return b
    if process == "nlvr":
        # [B, 2R, D] image pair -> [2B, R, D]; text repeated per image
        bsz, two_r = feats.shape[0], feats.shape[1]
        r = two_r // 2
        b["features"] = feats.reshape(bsz * 2, r, feats.shape[2])
        b["spatials"] = b["spatials"].reshape(bsz * 2, r, b["spatials"].shape[2])
        b["image_mask"] = b["image_mask"].reshape(bsz * 2, r)
        for k in ("question", "input_mask", "segment_ids"):
            b[k] = torch.repeat_interleave(b[k], 2, dim=0)
        return b
    raise ValueError(process)


def _task_logits(
    model: torch.nn.Module,
    model_cfg: ModelConfig,
    task: TaskConfig,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward with the task's head only; returns (logits, target) shaped
    as ``task_loss_and_score`` takes them."""
    head = HEAD_FOR_TYPE[task.type]
    p = process_batch(task.process, batch)
    task_ids = None
    if model_cfg.task_specific_tokens:
        task_ids = torch.full((p["question"].shape[0], 1), task.task_id, dtype=torch.long,
                              device=p["question"].device)
    out = model(
        p["question"], p["features"], p["spatials"], p["segment_ids"], p["input_mask"],
        p["image_mask"], p.get("co_attention_mask"), task_ids, heads=(head,),
    )
    logits = getattr(out, head)
    target = p["target"]
    if task.type == "VL-logit":
        # rank options: [B*N, 1] -> [rows, N], rows following the (possibly
        # flattened) target: B for expand/retrieval, B*rounds for dialog
        logits = logits.reshape(target.shape[0], -1)
    elif task.type == "V-logit-mc":
        # the option rows past the detector block, by advanced indexing: its
        # backward (a sorted index_put_ with accumulate) sums repeated
        # options in a fixed order on CUDA, where gather's (scatter_add_)
        # does not, so that a run repeats bit for bit
        mc = p["multiple_choice_ids"].long()
        rows = torch.arange(mc.shape[0], device=mc.device)[:, None]
        logits = logits[:, MC_REGION_OFFSET:, 0][rows, mc][..., None]
    if model_cfg.in_batch_pairs and logits.shape[0] != target.shape[0]:
        raise ValueError(
            f"in_batch_pairs: {logits.shape[0]} rows of {task.type} logits over the (text, "
            f"image) pairs, {target.shape[0]} rows of targets (the JAX loss fails on these "
            "shapes too)")
    return logits, target


def make_task_loss_fn(model_cfg: ModelConfig, task: TaskConfig, *,
                      deterministic: bool = False) -> Callable:
    """loss_fn(model, batch) -> (loss, {"score": batch score}) for the
    train step; the model runs in train mode unless ``deterministic``."""

    def loss_fn(model, batch):
        model.train(not deterministic)
        logits, target = _task_logits(model, model_cfg, task, batch)
        loss, score = task_loss_and_score(task.type, logits, target)
        return loss, {"score": score}

    return loss_fn


def make_task_eval_fn(model_cfg: ModelConfig, task: TaskConfig) -> Callable:
    """eval_fn(model, batch) -> ([rows] loss, [rows] score), eval mode, no
    gradients: per-sample vectors, so that padded final batches still give
    exact sample-weighted metrics (reference eval_tasks.py:276-301)."""

    @torch.no_grad()
    def eval_fn(model, batch):
        was_training = model.training
        model.eval()
        try:
            logits, target = _task_logits(model, model_cfg, task, batch)
        finally:
            model.train(was_training)
        return task_loss_and_score_per_sample(task.type, logits, target)

    return eval_fn


def host_batch(batch: Dict[str, Any], compute_dtype: str) -> Dict[str, torch.Tensor]:
    """A loader batch -> CPU tensors as the step takes them: without
    ``HOST_ONLY_KEYS``, features compressed for transfer under bf16."""
    b = to_tensors({k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS})
    return compress_for_transfer(b, compute_dtype)


def _repeat(loader) -> Iterator:
    """Endless stream over the loader's epochs."""
    while True:
        empty = True
        for batch in loader:
            empty = False
            yield batch
        if empty:
            raise ValueError("a task loader yielded no batch")


def _groups(it: Iterator, n: int) -> Iterator[List]:
    """Consecutive lists of ``n`` items of an endless ``it``."""
    while True:
        yield [next(it) for _ in range(n)]


def _stacked_host_batch(loader_batches: List[Dict[str, Any]], compute_dtype: str
                        ) -> Dict[str, torch.Tensor]:
    """Loader batches -> one host batch; more than one (gradient
    accumulation) stacked on a leading axis. A module function: the staging
    thread holds it, and must hold nothing of the trainer, or a trainer
    dropped without ``close`` would live on with its thread."""
    micro = [host_batch(b, compute_dtype) for b in loader_batches]
    if len(micro) == 1:
        return micro[0]
    return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}


@dataclass
class TaskRuntime:
    key: str
    cfg: TaskConfig
    loader: Any                      # train loader (numpy batches)
    val_loader: Optional[Any]
    loss_scale: float
    mask: Optional[Dict[str, bool]]  # the task's participation mask (adamw)
    step_fn: Callable                # step(model, batch, lr) -> metrics
    eval_fn: Callable                # per-sample (loss[rows], score[rows])
    device: Any = "cuda"
    compute_dtype: str = "float32"
    grad_accum: int = 1
    num_iters: int = 0
    prefetch_batches: int = 0
    iterator: Iterator = None

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The next training batch on the device (the loader restarts at its
        end), staged ``prefetch_batches`` ahead. With gradient
        accumulation, ``grad_accum`` loader batches stacked on a leading
        axis."""
        if self.iterator is None:
            self.iterator = device_prefetch(
                _groups(_repeat(self.loader), self.grad_accum), size=self.prefetch_batches,
                device=self.device,
                transform=functools.partial(_stacked_host_batch,
                                            compute_dtype=self.compute_dtype))
        return next(self.iterator)

    def close(self) -> None:
        """Stop the staging thread; the next batch starts a new one."""
        if self.iterator is not None:
            self.iterator.close()
            self.iterator = None


def _refuse_pairs_at_init(tasks: Dict[str, TaskConfig], loaders: Dict[str, Any]) -> None:
    """Fail where the JAX trainer's model init fails under in_batch_pairs:
    it runs every head on the first task's first batch, and vision_logit's
    image mask does not broadcast over the pairs of more than one row."""
    key = next(iter(tasks))
    first = next(iter(loaders[key]))
    batch = to_tensors({k: first[k] for k in ("question", "features", "spatials", "image_mask",
                                              "input_mask", "segment_ids")})
    question = process_batch(tasks[key].process, batch)["question"]
    rows = question.reshape(-1, question.shape[-1]).shape[0]
    if rows > 1:
        raise ValueError(
            f"in_batch_pairs: the two-stream model's heads cannot score the {rows}^2 (text, "
            f"image) pairs of {key}'s first batch (the JAX trainer's model init fails on them)")


class MultiTaskTrainer:
    """Round-robin multi-task driver (reference train_tasks.py:510-610).
    ``model`` is built from ``seed`` unless ``init_model`` is given;
    ``from_pretrained`` then loads a local ``.npz`` (the hits whose shapes
    match: a pretraining checkpoint leaves the task heads at init) or a
    reference ``.bin``. ``mesh``: data parallelism over its ranks (module
    docstring), on the mesh's device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        tasks: Dict[str, TaskConfig],
        loaders: Dict[str, Any],
        *,
        opt_cfg: Optional[OptimizerConfig] = None,
        train_cfg: Optional[TrainConfig] = None,
        val_loaders: Optional[Dict[str, Any]] = None,
        num_labels: int = 3129,
        init_model: Optional[ViLBERTForVLTasks] = None,
        seed: int = 0,
        mesh=None,
        num_train_epochs: int = 0,
        model_family: str = "vilbert",
        from_pretrained: str = "",
        dropout_prob: float = 0.1,
        device="cuda",
    ):
        if mesh is not None:
            device = mesh.device
        self.mesh = mesh
        if model_family not in ("vilbert", "basebert", "baseline"):
            raise ValueError(f"unknown model_family {model_family!r}")
        self.model_cfg = model_cfg
        self.device = torch.device(device)
        self.train_cfg = train_cfg or TrainConfig()
        self.grad_accum = max(self.train_cfg.gradient_accumulation_steps, 1)
        val_loaders = val_loaders or {}

        # per-task LR -> base lr + loss scales (train_tasks.py:239-251); the
        # default optimizer is the reference multi-task AdamW without bias
        # correction (train_tasks.py:425)
        base_lr = min(t.lr for t in tasks.values())
        self.loss_scales = {k: t.lr / base_lr for k, t in tasks.items()}
        opt_cfg = opt_cfg or OptimizerConfig(correct_bias=False)
        self.opt_cfg = opt_cfg.__class__(**{**opt_cfg.__dict__, "learning_rate": base_lr})

        # iterations per epoch: the MAX of per-task num_epoch * len(loader) *
        # multiplier / num_train_epochs (the reference's misnamed
        # median_num_iter, train_tasks.py:333-352)
        self.num_train_epochs = num_train_epochs or max(t.num_epoch for t in tasks.values())
        ave_iters = [
            int(t.num_epoch * len(loaders[k]) * self.train_cfg.train_iter_multiplier
                / self.num_train_epochs)
            for k, t in tasks.items()
        ]
        self.median_num_iter = max(ave_iters) // self.grad_accum if ave_iters else 0
        #: per-task train-loader length (reference task_num_iters), which
        #: gates the per-task evals (train_tasks.py:583-586)
        self.task_num_iters = {k: len(loaders[k]) for k in tasks}

        #: draws the initial weights (unless given) and every dropout seed
        self.generator = torch.Generator().manual_seed(seed)
        if init_model is not None:
            model = init_model
        elif model_family != "vilbert":
            # the reference --baseline model (train_tasks.py:232-237), at its
            # default dropout, as the JAX trainer builds it
            from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks

            model = BaseBertForVLTasks(model_cfg, num_labels=num_labels, generator=self.generator)
        else:
            model = ViLBERTForVLTasks(model_cfg, num_labels=num_labels,
                                      dropout_prob=dropout_prob, generator=self.generator)
        if init_model is None and model.family == "vilbert" and model_cfg.in_batch_pairs:
            _refuse_pairs_at_init(tasks, loaders)
        refused = {k: t.type for k, t in tasks.items() if t.type in BASELINE_REFUSED_TYPES}
        if model.family == "basebert" and refused:
            raise ValueError(
                f"the single-stream baseline has no head for {refused} (reference "
                "basebert.py's 7 heads; the JAX trainer fails on these at their first "
                "iteration)")
        if from_pretrained:
            load_pretrained(model, from_pretrained)
        self.model = model.to(self.device)
        set_dropout_generator(self.model, self.generator,
                              rank=mesh.data_rank if mesh is not None else 0)
        set_pair_mesh(self.model, mesh)
        params = dict(self.model.named_parameters())

        # the schedule is a function of ITERATIONS: the LR advances once per
        # round-robin iteration while the optimizer steps once per task
        # (train_tasks.py:541-559); one optimizer, one state for all tasks
        total_iterations = self.median_num_iter * self.num_train_epochs or 1000
        self.optimizer, self.schedule = build_optimizer(
            self.opt_cfg, params, total_iterations,
            freeze_prefix=self.train_cfg.freeze_prefix, external_lr=True,
            family=model.family,
        )
        self.tasks: Dict[str, TaskRuntime] = {}
        for key, tcfg in tasks.items():
            # adamw: params outside the task's backward graph (other heads,
            # cls, the poolers for V-logit) take no moment update or weight
            # decay; radam, and the baseline (as in the JAX trainer), have no
            # mask (a zero gradient steps them)
            mask = (task_update_mask(params, tcfg.type)
                    if self.opt_cfg.name == "adamw" and model.family == "vilbert" else None)
            self.tasks[key] = TaskRuntime(
                key=key, cfg=tcfg, loader=loaders[key], val_loader=val_loaders.get(key),
                loss_scale=self.loss_scales[key], mask=mask,
                step_fn=make_train_step(
                    make_task_loss_fn(model_cfg, tcfg), self.optimizer,
                    loss_scale=self.loss_scales[key], external_lr=True,
                    grad_accum=self.grad_accum, grad_dtype=self.train_cfg.grad_dtype or None,
                    update_mask=mask, mesh=mesh,
                ),
                eval_fn=make_task_eval_fn(model_cfg, tcfg),
                device=self.device, compute_dtype=model_cfg.compute_dtype,
                grad_accum=self.grad_accum, num_iters=len(loaders[key]),
                prefetch_batches=self.train_cfg.prefetch_batches,
            )
        if mesh is not None:
            mesh.replicate(self.model, self.optimizer)
        self.controller = MultiTaskStopController(
            list(tasks), train_iter_gap=self.train_cfg.train_iter_gap)
        self.global_step = 0
        self.epoch = 0
        self._last_val_scores: Dict[str, float] = {}
        self.metrics_logger = None  # optional MetricsLogger (attach_logger)
        self._ckpt = None

    # -- observability / checkpointing --------------------------------------

    def attach_logger(self, log_dir: str):
        from vilbert_tpu_torch.train.logger import MetricsLogger

        self.metrics_logger = MetricsLogger(
            log_dir, list(self.tasks), write=self.mesh is None or self.mesh.is_primary)
        return self.metrics_logger

    def close(self) -> None:
        """Stop the tasks' staging threads."""
        for task in self.tasks.values():
            task.close()

    def _ckpt_manager(self):
        if self._ckpt is None:
            from vilbert_tpu_torch.core.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(self.train_cfg.checkpoint_dir, mesh=self.mesh)
        return self._ckpt

    def _state(self) -> Dict[str, Any]:
        return {"params": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def save_checkpoint(self, step: Optional[int] = None) -> str:
        """Full training state into ``train_cfg.checkpoint_dir`` at ``step``
        (default ``global_step``): parameters and optimizer state, and as
        host state the controllers, ``global_step``, ``epoch``, the schedule
        and the logger (reference train_tasks.py:612-635). Returns the step
        directory."""
        host = {
            "controllers": self.controller.state_dict(),
            "global_step": self.global_step,
            "epoch": self.epoch,
        }
        if hasattr(self.schedule, "state_dict"):
            host["schedule"] = self.schedule.state_dict()
        if self.metrics_logger is not None:
            host["logger"] = self.metrics_logger.state_dict()
        return self._ckpt_manager().save(
            self.global_step if step is None else step, self._state(), host_state=host)

    def restore_checkpoint(self, step: Optional[int] = None,
                           directory: Optional[str] = None) -> int:
        """Resume the state ``save_checkpoint`` wrote (reference
        train_tasks.py:463-481), the latest step unless ``step`` is given;
        ``directory`` overrides the configured one (``--resume_file``).
        Returns the step restored."""
        from vilbert_tpu_torch.core.checkpoint import CheckpointManager

        mngr = CheckpointManager(directory, mesh=self.mesh) if directory else self._ckpt_manager()
        saved, host, step = mngr.restore(self._state(), step=step)
        self.model.load_state_dict(saved["params"])
        self.optimizer.load_state_dict(saved["optimizer"])
        if host:
            self.controller.load_state_dict(host.get("controllers", {}))
            self.global_step = host.get("global_step", 0)
            self.epoch = host.get("epoch", 0)
            if "schedule" in host and hasattr(self.schedule, "load_state_dict"):
                self.schedule.load_state_dict(host["schedule"])
            if self.metrics_logger is not None and "logger" in host:
                self.metrics_logger.load_state_dict(host["logger"])
        return step

    # -- loops --------------------------------------------------------------

    def train_iteration(self, iter_id: int, task_hooks: Optional[list] = None
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
        """One round-robin pass over the tasks (train_tasks.py:513-570).

        ``task_hooks`` are called as hook(key, model, None) before a task's
        step and hook(key, model, metrics) after it. Each trained task is a
        span ``train.task_step`` (``task``, ``rows``: ``batch_rows``) over
        its batch's arrival and its step."""
        out = {}
        # the reference's warmup scheduler steps right after the FIRST
        # trained task's optimizer.step (train_tasks.py:548-556): within
        # iteration i the first task updates at lambda(i), every later one at
        # mid_iteration(i)
        lr_first = float(np.float32(self.schedule(self.global_step)))
        if hasattr(self.schedule, "mid_iteration"):
            lr_rest = self.schedule.mid_iteration(self.global_step)
        else:
            lr_rest = self.schedule(self.global_step + 1)
        lr_rest = float(np.float32(lr_rest))
        first_task = True
        for key, task in self.tasks.items():
            if not self.controller.should_train(key, iter_id):
                continue
            lr = lr_first if first_task else lr_rest
            first_task = False
            with span("train.task_step", task=key) as traced:
                batch = task.next_batch()
                if traced:
                    traced.set(rows=batch_rows(batch, task.grad_accum))
                for hook in task_hooks or ():
                    hook(key, self.model, None)
                metrics = task.step_fn(self.model, batch, lr)
            for hook in task_hooks or ():
                hook(key, self.model, metrics)
            out[key] = metrics
        if self.metrics_logger is not None:
            for key, m in out.items():
                self.metrics_logger.step_train(
                    self.global_step, key, float(m["loss"]), float(m["score"]),
                    lr=float(self.schedule(self.global_step)))
        if out:
            # global_step (and the warmup clock) advance only when a task ran
            # (train_tasks.py:543-559)
            self.global_step += 1
        return out

    def evaluate(self, key: str, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Val pass for one task, feeding the stop controller
        (train_tasks.py:639-668). Final ragged batches are padded to the
        loader's batch size and the metrics are sample-weighted means over
        the valid rows."""
        from vilbert_tpu_torch.data.tasks import pad_batch

        task = self.tasks[key]
        if task.val_loader is None:
            raise ValueError(f"no val loader for {key}")
        full_bs = getattr(task.val_loader, "batch_size", 0)
        tot_loss = tot_score = 0.0
        n_rows = 0
        for i, batch in enumerate(task.val_loader):
            if max_batches and i >= max_batches:
                break
            batch = {k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS}
            bsz = int(np.shape(batch["features"])[0])
            if full_bs:
                batch, _ = pad_batch(batch, full_bs)
            dev = to_device(host_batch(batch, self.model_cfg.compute_dtype), self.device)
            loss_v, score_v = (t.cpu().numpy() for t in task.eval_fn(self.model, dev))
            # rows per sample > 1 for dialog (target flattened to B*rounds)
            rows_per_sample = loss_v.shape[0] // max(full_bs or bsz, 1)
            valid = bsz * max(rows_per_sample, 1)
            tot_loss += float(loss_v[:valid].sum())
            tot_score += float(score_v[:valid].sum())
            n_rows += valid
        if self.mesh is not None and self.mesh.distributed:
            # every rank must see the same score, or the stop controllers
            # (and the round-robin schedule) diverge across the ranks
            tot_loss, tot_score, n_rows = sum_host([tot_loss, tot_score, n_rows],
                                                   self.mesh.data_group)
        result = {"loss": tot_loss / max(n_rows, 1), "score": tot_score / max(n_rows, 1)}
        self._last_val_scores[key] = result["score"]
        self.controller.step(key, result["score"])
        if self.metrics_logger is not None:
            self.metrics_logger.step_val(self.global_step, key, result["loss"], result["score"])
        return result

    def _eval_due(self, epoch: int, it: int, num_epochs: int, key: str) -> bool:
        """Reference eval cadence (train_tasks.py:583-599): task ``key`` is
        evaluated after each reference iterId that is a nonzero multiple of
        its loader length, and at the last step of the last epoch. One of
        these iterations covers ``grad_accum`` reference iterIds, aligned on
        parameter state (see the JAX ``_eval_due``)."""
        n = self.task_num_iters.get(key, 0)
        ga = self.grad_accum
        lo = (epoch * self.median_num_iter + it) * ga + ga - 1
        hi = lo + ga
        wrapped = n > 0 and (hi - 1) // n > (max(lo, 1) - 1) // n
        last = epoch == num_epochs - 1 and it == self.median_num_iter - 1
        return wrapped or last

    def train(
        self,
        num_epochs: int = 0,
        *,
        eval_cadence: str = "reference",
        lr_drop_epochs: Tuple[int, ...] = (5, 7),
        log_every: int = 20,
        hooks: Optional[list] = None,
        task_hooks: Optional[list] = None,
        max_iterations: int = 0,
    ) -> ViLBERTForVLTasks:
        """Run the multi-task loop; returns the model.

        ``eval_cadence``: "reference" evaluates a task each time it wraps
        its loader (train_tasks.py:583-586), "epoch" every task at every
        epoch end. ``hooks`` are called as hook(epoch, it, trainer, metrics)
        after every iteration, ``task_hooks`` as in ``train_iteration``.
        ``max_iterations`` > 0 stops after that many iterations, without the
        rest of the epoch and its end-of-epoch transitions."""
        if eval_cadence not in ("reference", "epoch"):
            raise ValueError(eval_cadence)
        num_epochs = num_epochs or self.num_train_epochs
        done = 0
        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch
            t0 = time.perf_counter()
            for it in range(self.median_num_iter):
                # stopped tasks are gated on the GLOBAL iterId
                # (train_tasks.py:514-521)
                metrics = self.train_iteration(epoch * self.median_num_iter + it, task_hooks)
                if log_every and (it + 1) % log_every == 0:
                    host = {k: float(m["loss"]) for k, m in metrics.items()}
                    bad = [k for k, v in host.items() if not math.isfinite(v)]
                    if bad:
                        raise FloatingPointError(
                            f"non-finite loss at epoch {epoch} it {it + 1} for tasks {bad}")
                    logger.info("epoch %d it %d %s", epoch, it + 1, " ".join(
                        f"{k}:{host[k]:.3f}/{float(m['score']):.3f}"
                        for k, m in metrics.items()))
                if eval_cadence == "reference":
                    for key, task in self.tasks.items():
                        if task.val_loader is not None and self._eval_due(
                                epoch, it, num_epochs, key):
                            r = self.evaluate(key)
                            logger.info("epoch %d it %d eval %s loss %.4f score %.4f "
                                        "in_stop=%s", epoch, it, key, r["loss"], r["score"],
                                        self.controller.controllers[key].in_stop)
                for hook in hooks or ():
                    hook(epoch, it, self, metrics)
                done += 1
                if max_iterations and done >= max_iterations:
                    return self.model
            if eval_cadence == "epoch":
                for key, task in self.tasks.items():
                    if task.val_loader is not None:
                        r = self.evaluate(key)
                        logger.info("epoch %d eval %s loss %.4f score %.4f in_stop=%s",
                                    epoch, key, r["loss"], r["score"],
                                    self.controller.controllers[key].in_stop)
            # epoch-level LR transition (mannul x0.2 at {5, 7}, automatic
            # ReduceLROnPlateau on the summed val scores, train_tasks.py:595-605)
            if hasattr(self.schedule, "on_epoch_end"):
                self.schedule.on_epoch_end(
                    epoch, sum(self._last_val_scores.values()) if self._last_val_scores
                    else None)
            if epoch in lr_drop_epochs:
                # the reference resets every stop controller on the LR-drop
                # epochs (train_tasks.py:607-610)
                self.controller.reset_all()
            if self.train_cfg.checkpoint_every:
                self.save_checkpoint()
            logger.info("epoch %d done in %.1fs", epoch, time.perf_counter() - t0)
        return self.model


def load_pretrained(model: torch.nn.Module, path: str) -> None:
    """Weights from a local ``.npz`` (flat, keyed by flax path: the hits whose
    shapes match are loaded, the rest kept at init) or a reference torch
    checkpoint (through the importer's key migration) into ``model``, by the
    flax paths of its family (``core.weights``)."""
    from vilbert_tpu_torch.core.importer import _flatten, _unflatten
    from vilbert_tpu_torch.core.weights import (
        flax_from_state_dict,
        load_params_npz,
        load_weights,
        state_dict_from_flax,
    )

    if os.path.splitext(path)[1] != ".npz":
        load_weights(model, path)
        return
    keys = list(model.state_dict().keys())
    flat = _flatten(flax_from_state_dict(model.state_dict(), model.family))
    loaded = _flatten(load_params_npz(path))
    hits = {k: v for k, v in loaded.items() if k in flat and np.shape(v) == np.shape(flat[k])}
    flat.update(hits)
    model.load_state_dict(state_dict_from_flax(_unflatten(flat), keys, model.family))
    logger.info("from_pretrained %s: %d/%d params loaded", path, len(hits), len(flat))
