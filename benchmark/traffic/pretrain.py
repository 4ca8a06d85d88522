"""Conceptual Captions pretraining: the step ``run_pretraining`` builds.

The program's step is ``parallel.train_step.make_train_step`` over
``train.pretrain.make_pretrain_loss_fn`` and the model of
``train.pretrain.pretrain_model``, with ``train.optim.build_optimizer``'s
AdamW (fp32 moments; the schedule read one step ahead, as
``run_pretraining`` builds it), dropout seeds drawn from a CPU generator
(``models.layers.set_dropout_generator``). The window runs it closed-loop
over a ring of batches built on the device from the seed, in the dtypes the
driver's feed gives the step (``data.prefetch.compress_for_transfer``), and
reads the loss every ``log_every`` steps, where ``run_pretraining`` reads it
and nowhere else.

Set-up drives the step through its first ``check_steps`` steps on the
ring's first batches; the comparison reads the losses, the first step's
Adam moments and the parameters after them, and the plain reference
(``reference``) retraces the same steps from the same weights, batches and
dropout seeds after the window.

Mix parameters: ``batch_size``, ``seq_len`` (text positions), ``regions``
(detector boxes; the global row makes one more), ``text_len`` [lo, hi]
(valid tokens a caption), ``mask_prob``, ``ring``, ``lm_gather``,
``optimizer`` (learning rate, betas, eps, weight decay, schedule),
``log_every``, ``check_steps``, ``trace_units``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from harness import cell as harness_cell
from harness import seeded, yardstick
from harness.compare import Trajectory, training_gaps


def make_batch(p: Dict, sizes: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One CC batch, float32 and int32 as the loader yields them: captions of
    ``text_len`` valid tokens padded to ``seq_len``, ``mask_prob`` of the
    valid tokens and of the regions labelled, soft detector classes as
    region targets, an alignment label a pair."""
    b, t, r = p["batch_size"], p["seq_len"], p["regions"]
    vocab, feat, ncls = sizes["vocab_size"], sizes["v_feature_size"], sizes["v_target_size"]
    lo, hi = p["text_len"]

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    length = torch.randint(lo, hi + 1, (b,), generator=g, device=device)
    valid = torch.arange(t, device=device)[None] < length[:, None]
    ids = torch.randint(1, vocab, (b, t), generator=g, device=device)
    lm = torch.randint(0, vocab, (b, t), generator=g, device=device)
    target = rand(b, r, ncls)
    return {
        "input_ids": torch.where(valid, ids, 0).int(),
        "image_feat": torch.randn(b, r + 1, feat, generator=g, device=device),
        "image_loc": rand(b, r + 1, 5),
        "segment_ids": torch.zeros(b, t, dtype=torch.int32, device=device),
        "input_mask": valid.int(),
        "image_mask": torch.ones(b, r + 1, dtype=torch.int32, device=device),
        "lm_label_ids": torch.where(valid & (rand(b, t) < p["mask_prob"]), lm, -1).int(),
        "image_label": torch.where(rand(b, r) < p["mask_prob"], 1, -1).int(),
        "image_target": target / target.sum(-1, keepdim=True),
        "is_next": torch.randint(0, 2, (b,), generator=g, device=device).int(),
    }


def make_ring(p: Dict, sizes: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    g = seeded.generator(seed, "batches", device)
    return [make_batch(p, sizes, g, device) for _ in range(p["ring"])]


class Driver:
    train = True
    rate_metric, tail_metric = "samples_per_s", "step_ms_p90"

    def __init__(self, ctx: harness_cell.Context):
        self.ctx = ctx
        self.p = ctx.traffic
        self.sizes = ctx.sizes

    # -- the program -----------------------------------------------------------

    def _optimizer_config(self):
        from vilbert_tpu_torch.core.config import OptimizerConfig

        o = self.p["optimizer"]
        return OptimizerConfig(learning_rate=o["learning_rate"], beta1=o["beta1"],
                               beta2=o["beta2"], eps=o["eps"], weight_decay=o["weight_decay"],
                               schedule=o["schedule"], warmup_proportion=o["warmup_proportion"])

    def setup(self) -> None:
        from vilbert_tpu_torch.data.prefetch import compress_for_transfer
        from vilbert_tpu_torch.models.layers import set_dropout_generator
        from vilbert_tpu_torch.parallel.train_step import make_train_step
        from vilbert_tpu_torch.train.optim import build_optimizer
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn, pretrain_model

        dev, p = self.ctx.device, self.p
        self.cfg = cfg = self.ctx.model_config()
        with torch.device("meta"):  # the benchmark makes the weights, on the device
            model = pretrain_model(cfg, self.ctx.family)
        model = model.to_empty(device=dev)
        seeded.load_into(model, seeded.weights(
            [(n, tuple(t.shape)) for n, t in model.named_parameters()], self.ctx.seed,
            cfg.initializer_range, dev))
        dropout = seeded.generator(self.ctx.seed, "dropout")
        set_dropout_generator(model, dropout)
        opt, _ = build_optimizer(self._optimizer_config(), dict(model.named_parameters()),
                                 p["optimizer"]["total_steps"], step_offset=1,
                                 family=model.family)
        loss_fn = make_pretrain_loss_fn(cfg, lm_gather=p["lm_gather"], nce_generator=dropout)
        self.model, self.opt = model, opt
        self.step_fn = make_train_step(loss_fn, opt)
        self.ring = [compress_for_transfer(b, cfg.compute_dtype)
                     for b in make_ring(p, self.sizes, self.ctx.seed, dev)]
        self.steps = 0
        # the first steps warm every shape and are what the comparison reads
        losses = []
        for i in range(p["check_steps"]):
            losses.append(float(self._step()["loss"]))
            if i == 0:
                beta1 = p["optimizer"]["beta1"]
                self.grad1 = {n: (m.float() / (1.0 - beta1)).cpu()
                              for n, m in opt.state.mu.items()}
        self.after = {n: t.detach().to("cpu", copy=True)
                      for n, t in model.named_parameters()}
        self.losses = losses

    def _step(self):
        metrics = self.step_fn(self.model, self.ring[self.steps % len(self.ring)])
        self.steps += 1
        return metrics

    def run(self, seconds: float, max_units=None) -> harness_cell.Window:
        b, log_every = self.p["batch_size"], self.p["log_every"]
        clock = harness_cell.UnitClock(self.ctx.device)
        harness_cell.sync(self.ctx.device)
        t0 = time.perf_counter()
        clock.mark()
        n = 0
        while True:
            metrics = self._step()
            clock.mark()
            n += 1
            if self.steps % log_every == 0:  # run_pretraining's loss read
                loss = float(metrics["loss"])
                if loss != loss or abs(loss) == float("inf"):
                    raise FloatingPointError(f"non-finite loss at step {self.steps}")
            if (n >= max_units if max_units else time.perf_counter() - t0 >= seconds):
                break
        harness_cell.sync(self.ctx.device)
        wall = time.perf_counter() - t0
        return harness_cell.Window(samples=n * b, units=["step"] * n,
                                   unit_ms=clock.intervals_ms(), wall_s=wall)

    def unit_sites(self, unit: str) -> List[Dict]:
        c, p = self.sizes, self.p
        b, t, r = p["batch_size"], p["seq_len"], p["regions"] + 1
        h = c["hidden_size"]
        head_h = c["v_hidden_size"] if self.ctx.family == "vilbert" else h
        lm_rows = b * (p["lm_gather"] or t)
        return yardstick.encoder_sites(self.ctx.family, c, b, t, r) + [
            yardstick.matmul("head.lm_transform", lm_rows, h, h),
            yardstick.matmul("head.lm_decoder", lm_rows, c["vocab_size"], h),
            yardstick.matmul("head.image_transform", b * r, head_h, head_h),
            yardstick.matmul("head.image_decoder", b * r, c["v_target_size"], head_h),
            yardstick.matmul("head.align", b, 2, c.get("bi_hidden_size", h)
                             if self.ctx.family == "vilbert" else h),
            yardstick.layernorm("head.ln", lm_rows, h),
            yardstick.layernorm("head.image_ln", b * r, head_h),
        ]

    # -- the comparison ----------------------------------------------------------

    def program_trajectory(self) -> Trajectory:
        dev = self.ctx.device
        init = self._init_weights(dev)
        change = {n: self.after[n] - init[n].cpu() for n in init}
        return Trajectory(self.losses, self.grad1, change)

    def _init_weights(self, dev):
        from reference.model import PRETRAINING, Config

        with torch.device("meta"):
            shapes = PRETRAINING[self.ctx.family](Config(self.sizes))
        return seeded.weights([(n, tuple(t.shape)) for n, t in shapes.named_parameters()],
                              self.ctx.seed, self.sizes["initializer_range"], dev)

    def reference_trajectory(self, precision: str = "fp32", half: bool = False) -> Trajectory:
        """The plain reference's first steps from the same weights, batches
        and dropout seeds; ``half`` keeps the first half of each batch's
        rows alone (the half-batch fault)."""
        from reference.model import PRETRAINING, Config
        from reference.train import AdamW, pretrain_loss

        dev, p, o = self.ctx.device, self.p, self.p["optimizer"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            ref = PRETRAINING[self.ctx.family](Config(self.sizes), precision=precision)
        ref = ref.to_empty(device=dev)
        init = self._init_weights(dev)
        seeded.load_into(ref, init)
        ref.dropout_generator = seeded.generator(self.ctx.seed, "dropout")
        ref.train()
        params = dict(ref.named_parameters())
        opt = AdamW(params, lr=o["learning_rate"], betas=(o["beta1"], o["beta2"]), eps=o["eps"],
                    weight_decay=o["weight_decay"])
        ring = make_ring(p, self.sizes, self.ctx.seed, dev)
        losses, grad1 = [], None
        for i in range(p["check_steps"]):
            batch = ring[i % len(ring)]
            if half:
                batch = {k: v[: len(v) // 2] for k, v in batch.items()}
            for t in params.values():
                t.grad = None
            loss = pretrain_loss(ref, batch, p["lm_gather"])
            loss.backward()
            grads = {n: t.grad for n, t in params.items()}
            if grad1 is None:
                grad1 = {n: g.detach().float().cpu() for n, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
        change = {n: (params[n].detach() - init[n]).cpu() for n in params}
        return Trajectory(losses, grad1, change)

    def free(self) -> None:
        for name in ("model", "opt", "step_fn", "ring"):
            self.__dict__.pop(name, None)
        harness_cell.free_device_memory()

    def readings(self) -> Dict[str, float]:
        self.free()
        got = self.program_trajectory()
        return training_gaps(got, self.reference_trajectory())

    def close(self) -> None:
        self.free()
