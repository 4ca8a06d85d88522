"""12-in-1 multi-task fine-tuning: ``MultiTaskTrainer.train_iteration``.

The program is the trainer as ``cli.train_tasks.build_trainer`` builds it
for the mix's flags (AdamW without bias correction, the ``mannul``
schedule over iterations, the task heads at ``head_lr``, each task's loss
scaled by its lr over the least, task tokens, dropout 0.1, batches staged
``prefetch_batches`` ahead on a thread a task), given the benchmark's
seeded model (``init_model``) and synthetic loaders: one numpy batch a task
at its batch size and geometry (``configs/tasks.yml``), yielded
``loader_batches`` times an epoch. No logger, checkpoint or evaluation
runs in the window. The window runs whole round-robin iterations; a task
step's time runs from the end of the step before to its own end, read
from CUDA events recorded in ``task_hooks``. A sample is a row of a
task's loader batch (a retrieval row with its 4 options counts once).

Set-up runs the first iteration, which the comparison reads: each task
step's loss, the first step's Adam moment, and the parameters after the
iteration; the plain reference retraces it after the window with each
task's head, loss, loss scale, task token, learning rate and
participating parameters.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from harness import cell as harness_cell
from harness import seeded, yardstick
from harness.compare import Trajectory, training_gaps

#: rows of the detector block before the multiple-choice regions
MC_OFFSET = 101


def task_batch(task: Dict, b: int, sizes: Dict, rng: np.random.Generator) -> Dict:
    """A numpy batch at the task's text length and region count, in its
    process mode's layout: [B, 4, ...] for retrieval, [B, 2R, ...] images
    for nlvr, ``multiple_choice_ids`` and per-option targets for the
    V-logit-mc tasks (4 options for Visual7w, 204 for GuessWhatPointing);
    padded tokens and regions."""
    t_, r_ = task["max_seq_length"], task["max_region_num"]
    lead = (b, 4) if task.get("process") == "retrieval" else (b,)
    rows = 2 * r_ if task.get("process") == "nlvr" else r_
    kind = task["type"]

    def lengths(n, lo):
        if n == r_ and kind == "V-logit-mc":  # every region is a candidate
            return np.full(lead, n)
        return rng.integers(lo, n + 1, lead)

    t_len, r_len = lengths(t_, 3), lengths(rows, rows // 2)
    out = {
        "question": rng.integers(1, sizes["vocab_size"], lead + (t_,)).astype(np.int32),
        "input_mask": (np.arange(t_) < t_len[..., None]).astype(np.int32),
        "segment_ids": np.zeros(lead + (t_,), np.int32),
        "features": rng.standard_normal(lead + (rows, sizes["v_feature_size"]),
                                        dtype=np.float32),
        "spatials": rng.random(lead + (rows, 5), dtype=np.float32),
        "image_mask": (np.arange(rows) < r_len[..., None]).astype(np.int32),
    }
    if kind in ("VL-classifier", "VL-classifier-GQA"):
        n = task["num_labels"]
        target = np.zeros((b, n), np.float32)
        target[np.arange(b)[:, None], rng.integers(0, n, (b, 3))] = rng.choice(
            [0.3, 0.6, 1.0], (b, 3))
        out["target"] = target
    elif kind == "V-logit":
        hit = (rng.random((b, r_)) < 0.05) & (out["image_mask"] == 1)
        hit[:, 0] = False  # not the global row
        out["target"] = hit[..., None].astype(np.float32)
    elif kind == "V-logit-mc":
        out["multiple_choice_ids"] = rng.integers(0, r_ - MC_OFFSET,
                                                  (b, task["options"])).astype(np.int64)
        out["target"] = (rng.random((b, task["options"], 1)) < 0.25).astype(np.float32)
    elif task.get("process") == "retrieval":
        out["target"] = np.zeros((b,), np.int64)  # the true pair is option 0
    else:
        out["target"] = rng.integers(0, task["num_labels"], (b,)).astype(np.int64)
    return out


class _Loader:
    """One batch, ``n`` times an epoch."""

    def __init__(self, batch: Dict, n: int):
        self.batch, self.n = batch, n
        self.batch_size = len(batch["target"])

    def __iter__(self):
        return iter([self.batch] * self.n)

    def __len__(self):
        return self.n


def _program_task(task: Dict) -> Dict:
    return {k: v for k, v in task.items() if k not in ("num_labels", "options")}


class Driver:
    train = True
    rate_metric, tail_metric = "samples_per_s", "step_ms_p90"

    def __init__(self, ctx: harness_cell.Context):
        self.ctx = ctx
        self.p = ctx.traffic
        self.sizes = ctx.sizes
        self.tasks = self.p["tasks"]

    def _batches(self) -> Dict[str, Dict]:
        rng = np.random.default_rng(seeded.stream(self.ctx.seed, "batches"))
        return {k: task_batch(t, t["batch_size"], self.sizes, rng) for k, t in self.tasks.items()}

    def setup(self) -> None:
        from vilbert_tpu_torch.core.config import OptimizerConfig, TaskConfig, TrainConfig
        from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
        from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

        dev, p, o = self.ctx.device, self.p, self.p["optimizer"]
        cfg = self.ctx.model_config().replace(task_specific_tokens=True)
        with torch.device("meta"):  # the benchmark makes the weights, on the device
            model = ViLBERTForVLTasks(cfg, num_labels=p["num_labels"])
        model = model.to_empty(device=dev)
        seeded.load_into(model, seeded.weights(
            [(n, tuple(t.shape)) for n, t in model.named_parameters()], self.ctx.seed,
            cfg.initializer_range, dev))
        tasks = {k: TaskConfig(**_program_task(t)) for k, t in self.tasks.items()}
        self.batches = self._batches()
        loaders = {k: _Loader(b, p["loader_batches"]) for k, b in self.batches.items()}
        self.out_dir = tempfile.TemporaryDirectory()  # under the run's TMPDIR
        opt_cfg = OptimizerConfig(
            name="adamw", learning_rate=min(t.lr for t in tasks.values()),
            schedule=o["schedule"], warmup_proportion=o["warmup_proportion"],
            head_lr=o["head_lr"], correct_bias=o["correct_bias"], eps=o["eps"],
            beta1=o["beta1"], beta2=o["beta2"], weight_decay=o["weight_decay"])
        train_cfg = TrainConfig(train_iter_gap=p["train_iter_gap"],
                                checkpoint_dir=f"{self.out_dir.name}/ckpt",
                                prefetch_batches=p["prefetch_batches"])
        self.trainer = MultiTaskTrainer(
            cfg, tasks, loaders, opt_cfg=opt_cfg, train_cfg=train_cfg, val_loaders={},
            num_labels=p["num_labels"], init_model=model,
            seed=seeded.stream(self.ctx.seed, "dropout"), device=dev)
        self.iterations = 0
        # the first iteration warms every task's shapes and is what the
        # comparison reads
        losses, grad1 = [], {}
        beta1 = o["beta1"]

        def read(key, model, metrics):
            if metrics is None:
                return
            losses.append(float(metrics["loss"]))
            if not grad1:
                grad1.update({n: (m.float() / (1.0 - beta1)).cpu()
                              for n, m in self.trainer.optimizer.state.mu.items()})

        self.trainer.train_iteration(self.iterations, task_hooks=[read])
        self.iterations += 1
        self.losses, self.grad1 = losses, grad1
        self.after = {n: t.detach().to("cpu", copy=True)
                      for n, t in self.trainer.model.named_parameters()}

    def run(self, seconds: float, max_units=None) -> harness_cell.Window:
        clock = harness_cell.UnitClock(self.ctx.device)
        units: List[str] = []

        def hook(key, model, metrics):
            if metrics is not None:
                clock.mark()
                units.append(key)

        harness_cell.sync(self.ctx.device)
        t0 = time.perf_counter()
        clock.mark()
        while True:
            self.trainer.train_iteration(self.iterations, task_hooks=[hook])
            self.iterations += 1
            if (len(units) >= max_units if max_units else time.perf_counter() - t0 >= seconds):
                break
        harness_cell.sync(self.ctx.device)
        wall = time.perf_counter() - t0
        samples = sum(self.tasks[k]["batch_size"] for k in units)
        return harness_cell.Window(samples=samples, units=units, unit_ms=clock.intervals_ms(),
                                   wall_s=wall)

    def unit_sites(self, unit: str) -> List[Dict]:
        """The products of one task step: the encoder at the task's rows (the
        options and image pairs unrolled), text positions (with the task
        token) and regions; the task's head; for the V-logit types, whose
        loss reads the image stream alone, no backward through the text
        layers after the last co-attention nor that layer's text side; for
        NLVR2, the pretraining heads the model computes and no loss reads."""
        c, t = self.sizes, self.tasks[unit]
        rows = t["batch_size"] * (4 if t.get("process") == "retrieval" else 1)
        rows *= 2 if t.get("process") == "nlvr" else 1
        tt, r = t["max_seq_length"] + 1, t["max_region_num"]
        h, vh, bi = c["hidden_size"], c["v_hidden_size"], c["bi_hidden_size"]
        sites = yardstick.vilbert_sites(c, rows, tt, r)
        kind = t["type"]
        if kind in ("V-logit", "V-logit-mc"):
            sites = [dict(s, grad=False) if s["name"].startswith("pool.") else s
                     for s in sites]
            sites += _forward_only_tail(c, rows, tt, r)
            return sites + [yardstick.matmul("head.vision_logit", rows * r, 1, vh)]
        head = {
            "VL-classifier": [yardstick.matmul("head.vqa_hidden", rows, 2 * bi, bi),
                              yardstick.matmul("head.vqa_out", rows, t.get("num_labels", 0),
                                               2 * bi)],
            "VL-classifier-GQA": [yardstick.matmul("head.gqa_hidden", rows, 2 * bi, bi),
                                  yardstick.matmul("head.gqa_out", rows,
                                                   t.get("num_labels", 0), 2 * bi)],
            "VL-logit": [yardstick.matmul("head.vil_logit", rows, 1, bi)],
            "VL-tri-classifier": [yardstick.matmul("head.tri", rows, 3, bi)],
            "VL-binary-classifier": [
                yardstick.matmul("head.pair_hidden", rows // 2, 2 * bi, 2 * bi),
                yardstick.matmul("head.pair_out", rows // 2, 2, 2 * bi),
                *[dict(s, grad=False) for s in (
                    yardstick.matmul("cls.lm_transform", rows * tt, h, h),
                    yardstick.matmul("cls.lm_decoder", rows * tt, c["vocab_size"], h),
                    yardstick.matmul("cls.image_transform", rows * r, vh, vh),
                    yardstick.matmul("cls.image_decoder", rows * r, c["v_target_size"], vh),
                    yardstick.matmul("cls.align", rows, 2, bi))]],
        }[kind]
        return sites + head

    # -- the comparison ----------------------------------------------------------

    def program_trajectory(self) -> Trajectory:
        dev = self.ctx.device
        init = self._init_weights(dev)
        change = {n: self.after[n] - init[n].cpu() for n in init}
        return Trajectory(self.losses, self.grad1, change)

    def _reference_model(self, precision: str = "fp32"):
        from reference.model import Config, ViLBERTForVLTasks

        with torch.device("meta"):
            return ViLBERTForVLTasks(Config(self.sizes, task_specific_tokens=True),
                                     num_labels=self.p["num_labels"], precision=precision)

    def _init_weights(self, dev):
        return seeded.weights([(n, tuple(t.shape))
                               for n, t in self._reference_model().named_parameters()],
                              self.ctx.seed, self.sizes["initializer_range"], dev)

    def reference_trajectory(self, precision: str = "fp32", half: bool = False) -> Trajectory:
        """The plain reference's first iteration from the same weights,
        batches and dropout seeds: each task's step at its learning rate
        (the heads at ``head_lr``), its loss scale, over its participating
        parameters (``reference.tasks``), in blocks of at most
        ``reference_rows`` model rows. ``half`` keeps the first half of each
        batch's rows alone."""
        from reference.tasks import iteration_rates, participating, task_loss
        from reference.train import AdamW

        dev, p, o = self.ctx.device, self.p, self.p["optimizer"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self._reference_model(precision).to_empty(device=dev)
        init = self._init_weights(dev)
        seeded.load_into(ref, init)
        ref.dropout_generator = seeded.generator(self.ctx.seed, "dropout")
        ref.train()
        params = dict(ref.named_parameters())
        base_lr = min(t["lr"] for t in self.tasks.values())
        opt = AdamW(params, lr=base_lr, betas=(o["beta1"], o["beta2"]), eps=o["eps"],
                    weight_decay=o["weight_decay"], correct_bias=o["correct_bias"])
        ratios = {n: o["head_lr"] / base_lr for n in params if n.startswith(HEAD_PREFIXES)}
        first, rest = iteration_rates(o, base_lr, self.tasks, p["loader_batches"])
        losses, grad1 = [], None
        for i, (key, batch) in enumerate(self._batches().items()):
            task = self.tasks[key]
            n = len(batch["target"]) // (2 if half else 1)
            # model rows a sample: a retrieval row's 4 options, an NLVR2 pair
            unit = {"retrieval": 4, "nlvr": 2}.get(task.get("process"), 1)
            block = max(p["reference_rows"] // unit, 1)
            for t in params.values():
                t.grad = None
            loss_sum = 0.0
            for s0 in range(0, n, block):
                part = {k: torch.as_tensor(v[s0:min(s0 + block, n)], device=dev)
                        for k, v in batch.items()}
                ref.rows_from(s0 * unit)
                loss = task_loss(ref, task, part) * (len(part["target"]) / n)
                (loss * (task["lr"] / base_lr)).backward()
                loss_sum += float(loss.detach())
                del part, loss
            grads = {n_: t.grad for n_, t in params.items() if t.grad is not None}
            if grad1 is None:
                grad1 = {n_: (grads[n_].float() if n_ in grads else torch.zeros_like(t)).cpu()
                         for n_, t in params.items()}
            opt.step(grads, lr=first if i == 0 else rest,
                     names=participating(params, task["type"]), ratios=ratios)
            losses.append(loss_sum)
        change = {n: (params[n].detach() - init[n]).cpu() for n in params}
        return Trajectory(losses, grad1, change)

    def free(self) -> None:
        trainer = self.__dict__.pop("trainer", None)
        if trainer is not None:
            trainer.close()
        harness_cell.free_device_memory()

    def readings(self) -> Dict[str, float]:
        self.free()
        return training_gaps(self.program_trajectory(), self.reference_trajectory())

    def close(self) -> None:
        self.free()
        out = self.__dict__.pop("out_dir", None)
        if out is not None:
            out.cleanup()


#: the task heads the reference trains at ``head_lr`` (its "vil_" parameters)
HEAD_PREFIXES = ("vil_prediction.", "vil_prediction_gqa.", "vil_binary_prediction.",
                 "vil_logit.", "vil_tri_prediction.")


def _forward_only_tail(c, rows: int, tt: int, r: int) -> List[Dict]:
    """A V-logit step's products that its loss does not reach: the text
    layers after the last co-attention and that layer's text side (its text
    queries over the image keys and values, and what follows them), which
    run forward only. ``vilbert_sites`` counts every layer; these entries take
    their backward back out (negative counts of ``grad`` sites, forward
    added again)."""
    h, bi, inner = c["hidden_size"], c["bi_hidden_size"], c["intermediate_size"]
    heads, bh = c["num_attention_heads"], c["bi_num_attention_heads"]
    trailing = c["num_hidden_layers"] - c["t_biattention_id"][-1]
    bt = rows * tt
    tail = [
        yardstick.matmul("tail.qkvo", bt, h, h, 4 * trailing),
        yardstick.matmul("tail.co_image_kv", rows * r, bi, c["v_hidden_size"], 2),
        yardstick.matmul("tail.ffn", bt, inner, h, 2 * trailing),
        yardstick.attention("tail.self", rows, heads, h // heads, tt, tt, trailing),
        yardstick.matmul("tail.co_text_q", bt, bi, h),
        yardstick.attention("tail.co_text_to_image", rows, bh, bi // bh, tt, r),
        yardstick.matmul("tail.co_text_out", bt, h, bi),
        yardstick.matmul("tail.co_text_ffn", bt, inner, h, 2),
    ]
    return ([dict(s, count=-s["count"]) for s in tail]
            + [dict(s, grad=False) for s in tail])
