"""CLI: 12-in-1 multi-task fine-tuning on PyTorch (mirrors the reference
train_tasks.py and ``vilbert_tpu.cli.train_tasks``).

  python -m vilbert_tpu_torch.cli.train_tasks \\
      --config configs/bert_base_6layer_6conect.json \\
      --tasks_yml configs/tasks.yml --tasks 1-2-4-7-8-9-10-11-12-13-15-17 \\
      --from_pretrained pretrained_model.bin --task_specific_tokens

  # smoke test without data artifacts, on the CPU:
  python -m vilbert_tpu_torch.cli.train_tasks --synthetic --tasks 1-12 \\
      --device cpu --num_iterations 2

Writes ``params_final.npz`` (flat, keyed by flax path) into
``--output_dir``; with ``--checkpoint_every`` a full-state checkpoint at the
end of every epoch into ``<output_dir>/ckpt``, which ``--resume_file``
resumes. ``freeze_prefixes`` and ``_synthetic_world`` are copies of
the JAX CLI's (``tests/test_torch_host.py`` holds them to it); the other
CLIs of the port use them too. ``--tasks_yml`` needs PyYAML; ``train``
also takes the ``TaskConfig``s and loaders from its caller.

Data parallelism: ``--coordinator host:port --num_processes N
--process_id r`` (or a ``torchrun`` launch) joins N processes, as
``train_concap`` does; each loads its shard of every task's data (the
per-task batch divided by the processes, ``data.loading``; the synthetic
loaders are sharded likewise), and rank 0 writes the logs, checkpoints and
``params_final.npz``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/bert_base_6layer_6conect.json")
    p.add_argument("--tasks_yml", default="configs/tasks.yml")
    p.add_argument("--tasks", default="1", help="dash-separated task numbers")
    p.add_argument("--from_pretrained", default="", help="local .npz or reference .bin")
    p.add_argument("--vocab", default="")
    p.add_argument("--output_dir", default="checkpoints/multitask")
    p.add_argument("--num_epochs", type=int, default=0, help="0 = max task epochs")
    p.add_argument("--num_iterations", type=int, default=0,
                   help="stop after this many round-robin iterations (0: the whole schedule)")
    p.add_argument("--learning_rate", type=float, default=0.0,
                   help="0 = min of per-task lrs (reference behavior)")
    p.add_argument("--head_lr", type=float, default=1e-4,
                   help="lr for task heads (train_tasks.py:379-398)")
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--adam_correct_bias", action="store_true",
                   help="Adam bias correction (the reference runs without it)")
    p.add_argument("--clip_grad_norm", type=float, default=0.0,
                   help="global grad-norm clip before the optimizer; 0 = off")
    p.add_argument("--bf16_adam_state", action="store_true",
                   help="store the Adam moments in bfloat16 (they accumulate in fp32)")
    p.add_argument("--bf16_grads", action="store_true",
                   help="differentiate with respect to bf16 copies of the parameters")
    p.add_argument("--lr_scheduler", default="mannul",
                   choices=["mannul", "automatic", "cosine", "cosine_warm",
                            "warmup_linear", "warmup_constant", "constant"])
    p.add_argument("--optim", default="adamw", choices=["adamw", "radam"])
    p.add_argument("--baseline", action="store_true",
                   help="single-stream basebert model (train_tasks.py:232-237)")
    p.add_argument("--resume_file", default="",
                   help="checkpoint directory to resume the full training state from")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="nonzero: a full-state checkpoint at every epoch end "
                        "(TrainConfig.checkpoint_every)")
    p.add_argument("--freeze", default="",
                   help="param path prefix(es, comma-separated) to freeze; an INTEGER N "
                        "freezes the text embeddings + text layers 0..N (-1 = nothing)")
    p.add_argument("--train_iter_gap", type=int, default=4)
    p.add_argument("--train_iter_multiplier", type=float, default=1.0,
                   help="scale per-task iterations/epoch (train_tasks.py:339)")
    p.add_argument("--vision_scratch", action="store_true",
                   help="train fresh (non-text-BERT) weights at head_lr")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--save_name", default="",
                   help="suffix for the run directory under output_dir")
    p.add_argument("--clean_train_sets", type=lambda s: s.lower() != "false",
                   default=True, metavar="BOOL",
                   help="drop test-set image ids from train annotations (default true)")
    p.add_argument("--eval_cadence", default="reference", choices=["reference", "epoch"])
    p.add_argument("--bert_model", default="bert-base-uncased",
                   help="'roberta' selects RoBERTa embeddings")
    p.add_argument("--task_specific_tokens", action="store_true")
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for flag parity; on CUDA the port always runs its kernels")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the initial weights and every dropout mask")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--coordinator", default="",
                   help="host:port of rank 0 for a multi-process run (torch.distributed)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def optimizer_config(args: argparse.Namespace, base_lr: float):
    """The CLI's optimizer settings (as the JAX CLI builds them)."""
    from vilbert_tpu_torch.core.config import OptimizerConfig

    moments = "bfloat16" if args.bf16_adam_state else "float32"
    return OptimizerConfig(
        name=args.optim,
        learning_rate=args.learning_rate or base_lr,
        schedule=args.lr_scheduler,
        warmup_proportion=args.warmup_proportion,
        head_lr=args.head_lr,
        vision_scratch=args.vision_scratch,
        correct_bias=args.adam_correct_bias,
        grad_clip_norm=args.clip_grad_norm or None,
        first_moment_dtype=moments,
        second_moment_dtype=moments,
    )


def build_trainer(args: argparse.Namespace, task_cfgs=None, loaders=None, *,
                  val_loaders=None):
    """The ``MultiTaskTrainer`` for parsed flags, with its logger attached
    and, with ``--resume_file``, the checkpoint restored; not trained.

    ``task_cfgs`` ({"TASKn": TaskConfig}) replaces ``--tasks_yml`` and
    ``--tasks``; ``loaders`` (and ``val_loaders``) replace the data the
    flags name. A multi-process run joins its process group here."""
    from vilbert_tpu_torch.cli.train_concap import setup_distributed
    from vilbert_tpu_torch.core.config import ModelConfig, TrainConfig, load_task_configs
    from vilbert_tpu_torch.parallel.distributed import process_shard
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    device, mesh = setup_distributed(args)
    rank, world = process_shard(mesh)

    model_cfg = ModelConfig.from_json_file(
        args.config,
        task_specific_tokens=args.task_specific_tokens,
        dynamic_attention=args.dynamic_attention,
        use_pallas_attention=args.use_pallas,
        model="roberta" if "roberta" in args.bert_model else "bert",
    )
    if task_cfgs is None:
        all_tasks = load_task_configs(args.tasks_yml)
        task_cfgs = {f"TASK{n}": all_tasks[f"TASK{n}"] for n in args.tasks.split("-")}
    if loaders is None:
        if args.synthetic:
            loaders, val_loaders = _synthetic_world(task_cfgs, model_cfg.vocab_size), {}
            for loader in loaders.values():
                loader.shard_id, loader.num_shards = rank, world
        else:
            from vilbert_tpu_torch.data.loading import load_datasets
            from vilbert_tpu_torch.data.tokenization import load_tokenizer

            tokenizer = load_tokenizer(args.vocab or None, model_cfg.vocab_size)
            loaders, val_loaders = load_datasets(
                task_cfgs, tokenizer, seed=args.seed,
                grad_accum=args.gradient_accumulation_steps,
                shard_id=rank, num_shards=world,
                clean_train_sets=args.clean_train_sets,
            )
    if args.save_name:
        # run directory named like the reference's timeStamp
        # (train_tasks.py:253-261: tasks + config stem + "-" + save_name)
        args.output_dir = os.path.join(
            args.output_dir,
            "-".join(sorted(task_cfgs)) + "_"
            + os.path.splitext(os.path.basename(args.config))[0] + "-" + args.save_name,
        )
    trainer = MultiTaskTrainer(
        model_cfg, task_cfgs, loaders,
        opt_cfg=optimizer_config(args, min(t.lr for t in task_cfgs.values())),
        train_cfg=TrainConfig(
            freeze_prefix=freeze_prefixes(args.freeze),
            train_iter_gap=args.train_iter_gap,
            train_iter_multiplier=args.train_iter_multiplier,
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            grad_dtype="bfloat16" if args.bf16_grads else "",
            checkpoint_dir=f"{args.output_dir}/ckpt",
            checkpoint_every=args.checkpoint_every),
        val_loaders=val_loaders,
        seed=args.seed,
        num_train_epochs=args.num_epochs,
        model_family="basebert" if args.baseline else "vilbert",
        from_pretrained=args.from_pretrained,
        device=device,
        mesh=mesh,
    )
    trainer.attach_logger(f"{args.output_dir}/logs")
    if args.resume_file:
        step = trainer.restore_checkpoint(directory=args.resume_file)
        logging.info("resumed from %s at step %d (epoch %d)", args.resume_file, step,
                     trainer.epoch)
    return trainer


def train(args: argparse.Namespace, task_cfgs=None, loaders=None, hooks: Optional[list] = None,
          *, val_loaders=None, task_hooks: Optional[list] = None):
    """The CLI's body without the final save: ``build_trainer`` and its loop
    for parsed flags; returns the trainer. ``hooks`` and ``task_hooks`` go
    to ``MultiTaskTrainer.train``."""
    trainer = build_trainer(args, task_cfgs, loaders, val_loaders=val_loaders)
    trainer.train(args.num_epochs, eval_cadence=args.eval_cadence, hooks=hooks,
                  task_hooks=task_hooks, max_iterations=args.num_iterations)
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags, train, write ``params_final.npz``; returns the
    trainer."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    trainer = train(args)

    from vilbert_tpu_torch.cli.train_concap import finish_distributed
    from vilbert_tpu_torch.core.weights import save_params_npz

    path = os.path.join(args.output_dir, "params_final.npz")

    def write():
        save_params_npz(path, trainer.model)
        logging.info("saved %s", path)

    finish_distributed(write)
    return trainer


def freeze_prefixes(spec: str):
    """Expand --freeze into param-path prefixes.

    An integer N reproduces the reference (train_tasks.py:381-393: freeze
    the params named in the bert weight manifest whose layer number ≤ N —
    i.e. the TEXT embeddings and text encoder layers 0..N; -1 = none).
    Otherwise: comma-separated literal path prefixes.
    """
    spec = spec.strip()
    if not spec:
        return ()
    try:
        n = int(spec)
    except ValueError:
        return tuple(s.strip() for s in spec.split(",") if s.strip())
    if n < 0:
        return ()
    # both family spellings: two-stream vilbert nests text layers under
    # bert.encoder.layer_N, the single-stream baseline under bert.layer_N
    # (prefixes that match nothing are inert)
    return ("bert.embeddings.",) + tuple(
        f"bert.encoder.layer_{i}." for i in range(n + 1)
    ) + tuple(
        f"bert.layer_{i}." for i in range(n + 1)
    )


def _synthetic_world(task_cfgs, tokenizer_vocab):
    """Synthetic loaders for the selected tasks (tests/dev machines)."""
    from vilbert_tpu_torch.data import synthetic as syn
    from vilbert_tpu_torch.data.tasks import DATASET_REGISTRY, DataLoader
    from vilbert_tpu_torch.data.tokenization import HashTokenizer

    tok = HashTokenizer(tokenizer_vocab)
    store = syn.synthetic_store(num_images=16, num_boxes=8, feature_dim=2048)
    loaders = {}
    for key, t in task_cfgs.items():
        mk = dict(tokenizer=tok, max_seq_length=t.max_seq_length,
                  max_region_num=min(t.max_region_num, 20))
        cls = DATASET_REGISTRY[t.name]
        if t.type in ("VL-classifier", "VL-classifier-GQA"):
            ds = cls(syn.vqa_annotations(num=16, num_labels=3129), store,
                     num_labels=3129, **mk)
        elif t.type == "VL-logit" and t.process == "expand":
            ds = cls(syn.expand_annotations(num=8), store, **mk)
        elif t.type == "VL-logit":
            ds = cls(syn.retrieval_annotations(num=8), store, **mk)
        elif t.type == "V-logit":
            ds = cls(syn.grounding_annotations(store, num=16), store, **mk)
        elif t.type == "V-logit-mc":
            mk["max_region_num"] = 108
            ds = cls(syn.pointing_annotations(store, num=8), store, **mk)
        elif t.type == "VL-binary-classifier" and t.process == "nlvr":
            ds = cls(syn.nlvr2_annotations(num=8), store, **mk)
        else:
            ds = DATASET_REGISTRY["VisualEntailment"](
                syn.classification_annotations(num=16), store, **mk
            )
        loaders[key] = DataLoader(ds, batch_size=min(t.batch_size, 4), seed=0)
    return loaders


if __name__ == "__main__":
    main()
