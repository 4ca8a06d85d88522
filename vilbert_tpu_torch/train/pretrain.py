"""Conceptual Captions pretraining: the loss function and the driver.

Counterpart of ``vilbert_tpu/train/pretrain.py``:
``make_pretrain_loss_fn`` (the LM / region gathers and the objective
handling), ``evaluate_pretraining`` (the three raw losses, no dropout) and
``run_pretraining`` (forward, three losses, backward, ``reference_adamw``
on the schedule at ``count + 1``), for the two-stream model
(``model_family="vilbert"``) or the single-stream baseline
(``"basebert"``, reference ``--baseline``). On a CUDA device the model runs
the port's kernels: attention forward (K1, with dropout) and backward (K2),
the LayerNorm forward (K4).

Dropout seeds come from one CPU ``torch.Generator`` seeded from ``seed``,
which also draws the initial weights; the same seed gives the same steps.
Visual target 2 (NCE) draws its negatives from a generator on the device,
seeded per call of the loss from that same CPU generator (the JAX loss
splits its step key into a dropout key and an NCE key); evaluation seeds
it per batch from a generator of its own ``seed``. The JAX package's
threefry stream cannot be reproduced, so a run matches the JAX trajectory
only with dropout off and visual targets 0 and 1.

``run_pretraining`` can stage batches ``prefetch_batches`` ahead of the
step on a thread (``data.prefetch.device_prefetch``; the JAX driver stages
2); the thread touches only the loader, so the dropout and NCE streams,
drawn on the main thread, are the same at every depth. The default is 0,
each batch built between steps: on an H100 the CC loader's thread holds
the GIL that the step's launches need, and depth 2 measured no faster
than depth 0 (PERF.md). With a ``mesh`` (``parallel.mesh.Mesh``),
each data row of ranks trains on its shard of every batch, the data rows'
batches concatenated in order being the global batch: rank 0's weights
are broadcast first, the masks are the rows' of the global batch's
(``set_dropout_generator(rank=data_rank)``), ``in_batch_pairs`` pairs the
texts with the images of every data row (``models.vilbert.set_pair_mesh``),
the losses divide by the global counts (``train.losses``), the step
averages the gradients over the data axis, and the validation pass
averages over it. The state is replicated over a model axis, as the JAX
``run_pretraining`` replicates it.

``in_batch_pairs`` makes the two-stream model's outputs the B^2 (text,
image) pairs of a batch of B, which the pretraining losses cannot pair
with the batch's B rows of labels: the loss raises a ValueError naming it,
where the JAX loss fails on the shapes (B = 1 runs in both).

``run_pretraining(resume_dir=...)`` restores a full-state checkpoint
(``core.checkpoint``: parameters, optimizer state, step) and runs from its
step. As in the JAX package, the dropout stream and the loader start again
from ``seed`` on resume: a resumed run repeats the batches and masks of the
first steps, and equals the uninterrupted run only when every step sees the
same batch with dropout off.
"""

from __future__ import annotations

import itertools
import logging
import math
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig
from vilbert_tpu_torch.data.prefetch import (
    compress_for_transfer,
    device_prefetch,
    repeat_iterator,
    to_device,
    to_tensors,
)
from vilbert_tpu_torch.parallel.distributed import sum_host
from vilbert_tpu_torch.models.layers import set_dropout_generator
from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, set_pair_mesh
from vilbert_tpu_torch.ops.dropout import draw_seed
from vilbert_tpu_torch.parallel.train_step import (
    TrainState,
    load_train_state,
    make_train_step,
    train_state_dict,
)
from vilbert_tpu_torch.train.losses import pretrain_losses
from vilbert_tpu_torch.train.optim import build_optimizer

logger = logging.getLogger(__name__)


def _first_masked(masked: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the masked positions first, in order (a stable sort on an
    integer key), then the others; the first k per row."""
    return torch.sort((~masked).to(torch.int32), dim=1, stable=True).indices[:, :k]


def make_pretrain_loss_fn(
    cfg: ModelConfig,
    *,
    img_weight: float = 1.0,
    deterministic: bool = False,
    lm_gather: int = 0,
    img_gather: int = 0,
    apply_objective: bool = True,
    nce_generator: Optional[torch.Generator] = None,
    mesh=None,
) -> Callable:
    """loss_fn(model, batch) -> (loss, metrics) for ``make_train_step``.

    As ``vilbert_tpu.train.pretrain.make_pretrain_loss_fn``: objective 1
    clears the LM and region labels of misaligned pairs, objective 2 drops
    the alignment loss (``apply_objective=False`` skips both, as the
    validation pass does); ``lm_gather=K`` projects only the first K masked
    positions through the LM head, ``img_gather=K`` only the first K masked
    regions through the image head (visual targets 0 and 1; NCE keeps the
    full projection). The model runs in train mode unless ``deterministic``.
    With visual target 2, each call draws one seed from the CPU
    ``nce_generator`` for the generator on the batch's device that draws
    its negatives. ``mesh``: the losses are this rank's shares of the
    global batch's (``train.losses``).
    """
    if cfg.visual_target == 2 and nce_generator is None:
        raise ValueError("visual_target 2 (NCE) draws its negatives from nce_generator")
    use_img_gather = bool(img_gather) and cfg.visual_target in (0, 1)

    def loss_fn(model, batch: Dict[str, torch.Tensor]):
        model.train(not deterministic)
        lm_labels = batch["lm_label_ids"]
        lm_positions = None
        if lm_gather:
            masked = lm_labels != -1
            order = _first_masked(masked, lm_gather)
            lm_labels = torch.where(masked.gather(1, order), lm_labels.gather(1, order), -1)
            lm_positions = order
        image_label = batch["image_label"]
        image_target = batch["image_target"]
        img_positions = None
        if use_img_gather:
            # image_label row i is sequence_v row i + 1 (row 0 is the global feature)
            vmasked = image_label == 1
            vorder = _first_masked(vmasked, img_gather)
            image_label = torch.where(vmasked.gather(1, vorder), 1, -1)
            image_target = torch.take_along_dim(image_target, vorder[:, :, None], dim=1)
            img_positions = vorder + 1
        out = model(
            batch["input_ids"], batch["image_feat"], batch["image_loc"],
            batch["segment_ids"], batch["input_mask"], batch["image_mask"],
            lm_positions=lm_positions, img_positions=img_positions,
        )
        if out.seq_relationship_score.shape[0] != lm_labels.shape[0]:
            raise ValueError(
                f"in_batch_pairs: the model scores {out.seq_relationship_score.shape[0]} "
                f"(text, image) pairs, the pretraining losses take the batch's "
                f"{lm_labels.shape[0]} rows of labels (the JAX loss fails on these shapes too)")
        if apply_objective and cfg.objective == 1:
            aligned = (batch["is_next"] == 0)[:, None]
            lm_labels = torch.where(aligned, lm_labels, -1)
            image_label = torch.where(aligned, image_label, -1)
        generator = None
        if cfg.visual_target == 2:
            generator = torch.Generator(device=image_target.device)
            generator.manual_seed(draw_seed(nce_generator))
        losses = pretrain_losses(
            out, lm_labels, image_label, image_target, batch["is_next"],
            visual_target=cfg.visual_target, num_negative=cfg.num_negative,
            generator=generator, img_gathered=use_img_gather, mesh=mesh,
        )
        nsp = losses.next_sentence_loss
        if apply_objective and cfg.objective == 2:
            nsp = nsp * 0.0
        loss = losses.masked_lm_loss + losses.masked_img_loss * img_weight + nsp
        metrics = {
            "masked_loss_t": losses.masked_lm_loss,
            "masked_loss_v": losses.masked_img_loss,
            "next_sentence_loss": losses.next_sentence_loss,
        }
        return loss, metrics

    return loss_fn


def host_batch(batch: Dict[str, Any], cfg: ModelConfig, grad_accum: int = 1) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy) -> CPU tensors as the step takes them: no
    ``image_id``, compressed for transfer, split into ``grad_accum``
    microbatches along a new leading axis."""
    b = to_tensors({k: v for k, v in batch.items() if k != "image_id"})
    b = compress_for_transfer(b, cfg.compute_dtype, raw_feature_targets=cfg.visual_target != 0)
    if grad_accum > 1:
        n = next(iter(b.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch size {n} not divisible by grad_accum {grad_accum}")
        b = {k: v.reshape(grad_accum, n // grad_accum, *v.shape[1:]) for k, v in b.items()}
    return b


def pretrain_model(model_cfg: ModelConfig, model_family: str = "vilbert", *,
                   generator: Optional[torch.Generator] = None):
    """The pretraining model of a family: the two-stream ViLBERT or the
    single-stream baseline (reference --baseline, train_concap.py:397-414;
    the JAX ``_pretrain_model``)."""
    if model_family == "basebert":
        from vilbert_tpu_torch.models.basebert import BaseBertForPretraining

        return BaseBertForPretraining(model_cfg, generator=generator)
    if model_family != "vilbert":
        raise ValueError(f"model_family must be 'vilbert' or 'basebert', got {model_family!r}")
    return ViLBERTForPretraining(model_cfg, generator=generator)


@torch.no_grad()
def evaluate_pretraining(
    model_cfg: ModelConfig,
    model: torch.nn.Module,
    val_loader: Iterable[Dict[str, Any]],
    *,
    img_weight: float = 1.0,
    lm_gather: int = 0,
    img_gather: int = 0,
    device="cuda",
    seed: int = 0,
    mesh=None,
) -> Dict[str, float]:
    """The validation pass: mean {"loss", "masked_loss_t", "masked_loss_v",
    "next_sentence_loss"} over the batches, without dropout and without the
    objective transforms (reference train_concap.py:608-654). NCE draws
    each batch's negatives from a fixed per-batch seed of ``seed``. With a
    ``mesh``, each rank reads its shard of every batch, and the means are
    the global batches', the same on every rank."""
    loss_fn = make_pretrain_loss_fn(
        model_cfg, img_weight=img_weight, deterministic=True, lm_gather=lm_gather,
        img_gather=img_gather, apply_objective=False,
        nce_generator=torch.Generator().manual_seed(seed), mesh=mesh,
    )
    was_training = model.training
    totals: Dict[str, float] = {}
    n = 0
    for batch in val_loader:
        loss, metrics = loss_fn(model, to_device(host_batch(batch, model_cfg), device))
        for k, v in {**metrics, "loss": loss}.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        n += 1
    model.train(was_training)
    if mesh is not None and mesh.distributed:
        # each rank's losses are its shares of the global batch's: their
        # mean over the data axis is the global loss
        names = sorted(totals)
        summed = sum_host([totals[k] for k in names] + [n], mesh.data_group)
        totals = {k: float(v) / mesh.data_size for k, v in zip(names, summed)}
        n = int(summed[-1]) // mesh.data_size
    return {k: v / max(n, 1) for k, v in totals.items()}


def run_pretraining(
    model_cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    train_loader: Iterable[Dict[str, Any]],
    *,
    num_steps: int,
    seed: int = 0,
    img_weight: float = 1.0,
    grad_accum: int = 1,
    lm_gather: int = 0,
    img_gather: int = 0,
    model: Optional[torch.nn.Module] = None,
    model_family: str = "vilbert",
    device="cuda",
    log_every: int = 20,
    val_loader: Optional[Iterable] = None,
    val_every: int = 0,
    hooks: Optional[list] = None,
    freeze_prefix="",
    resume_dir: str = "",
    start_step: int = -1,
    grad_dtype: str = "",
    prefetch_batches: int = 0,
    mesh=None,
) -> TrainState:
    """The pretraining driver (``vilbert_tpu.train.pretrain.run_pretraining``).
    The model is ``model`` if given, else ``model_family``'s
    (``pretrain_model``) drawn from ``seed``; ``freeze_prefix`` and the
    learning-rate labels read the flax paths of the model's family.
    With ``val_loader``, a validation pass runs every ``val_every`` steps
    (default once after the last) and is logged. ``hooks`` are called as
    hook(step, state, metrics) after every step. Raises FloatingPointError
    on a non-finite loss at a logging step.

    ``resume_dir`` restores the latest full-state checkpoint there and runs
    from its step (``start_step`` >= 0 overrides it); the loader and the
    dropout stream start again from ``seed`` (module docstring).
    ``grad_dtype="bfloat16"`` takes the gradients in bf16
    (``parallel.train_step``). ``prefetch_batches``: the depth of the
    staging thread (0, the default: each batch built and copied between
    steps; module docstring).
    ``mesh``: data parallelism over its ranks (module docstring), on the
    mesh's device."""
    if mesh is not None:
        device = mesh.device
    generator = torch.Generator().manual_seed(seed)
    if model is None:
        model = pretrain_model(model_cfg, model_family, generator=generator)
    model = model.to(device)
    set_dropout_generator(model, generator, rank=mesh.data_rank if mesh is not None else 0)
    set_pair_mesh(model, mesh)

    # step_offset=1: the reference steps the LR scheduler BEFORE the
    # optimizer (train_concap.py:583-586), so update k trains at lambda(k)
    opt, schedule = build_optimizer(opt_cfg, dict(model.named_parameters()), num_steps,
                                    step_offset=1, freeze_prefix=freeze_prefix,
                                    family=model.family)
    loss_fn = make_pretrain_loss_fn(model_cfg, img_weight=img_weight,
                                    lm_gather=lm_gather, img_gather=img_gather,
                                    nce_generator=generator, mesh=mesh)
    step_fn = make_train_step(loss_fn, opt, grad_accum=grad_accum,
                              grad_dtype=grad_dtype or None, mesh=mesh)
    state = TrainState(0, model, opt)
    first_step = 0
    if resume_dir:
        from vilbert_tpu_torch.core.checkpoint import CheckpointManager

        saved, _, ckpt_step = CheckpointManager(resume_dir).restore(train_state_dict(state))
        state = load_train_state(state, saved)
        first_step = start_step if start_step >= 0 else ckpt_step
        logger.info("resumed from %s at step %d", resume_dir, first_step)
    if mesh is not None:
        mesh.replicate(model, opt)

    def run_validation(step: int) -> None:
        metrics = evaluate_pretraining(model_cfg, model, val_loader, img_weight=img_weight,
                                       lm_gather=lm_gather, img_gather=img_gather,
                                       device=device, seed=seed, mesh=mesh)
        nan = float("nan")
        logger.info("validation @ step %d: loss %.4f (t %.4f v %.4f nsp %.4f)", step,
                    metrics.get("loss", nan), metrics.get("masked_loss_t", nan),
                    metrics.get("masked_loss_v", nan), metrics.get("next_sentence_loss", nan))

    batches = repeat_iterator(lambda: iter(train_loader))
    # the first batch is taken here, before the thread starts (an empty
    # loader raises at once), as the JAX driver peeks it
    first = next(batches)
    stream = device_prefetch(
        itertools.chain([first], batches), size=prefetch_batches, device=device,
        transform=lambda b: host_batch(b, model_cfg, grad_accum))
    t0 = time.perf_counter()
    for step in range(first_step, num_steps):
        batch = next(stream)
        metrics = step_fn(model, batch)
        state = TrainState(step + 1, model, opt)
        if log_every and (step + 1) % log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(metrics["loss"]):
                raise FloatingPointError(f"non-finite loss at step {step + 1}: {metrics}")
            dt = time.perf_counter() - t0
            logger.info(
                "step %d loss %.4f (t %.4f v %.4f nsp %.4f) lr %.2e %.2f it/s",
                step + 1, metrics["loss"], metrics["masked_loss_t"], metrics["masked_loss_v"],
                metrics["next_sentence_loss"], float(schedule(step + 1)), log_every / dt)
            t0 = time.perf_counter()
        for hook in hooks or ():
            hook(step, state, metrics)
        if val_loader is not None and val_every and (step + 1) % val_every == 0:
            run_validation(step + 1)
            t0 = time.perf_counter()
    stream.close()
    if val_loader is not None and (not val_every or num_steps % val_every != 0):
        run_validation(num_steps)
    return state
