"""CLI: Conceptual Captions pretraining on PyTorch (mirrors the reference
train_concap.py and ``vilbert_tpu.cli.train_concap``).

  python -m vilbert_tpu_torch.cli.train_concap \\
      --config configs/bert_base_6layer_6conect.json \\
      --train_store data/cc_train.vfr --captions data/caption_train.json \\
      --vocab data/vocab.txt --batch_size 256 --num_epochs 10

  # smoke test without data artifacts, on the CPU:
  python -m vilbert_tpu_torch.cli.train_concap --synthetic --device cpu --num_steps 3

Writes ``params_final.npz`` (flat, keyed by flax path) into
``--output_dir``; ``vilbert_tpu.core.checkpoint.load_params`` reads it.
``--checkpoint_every N`` writes a full-state checkpoint (parameters,
optimizer state, step; ``core.checkpoint``) every N steps into
``<output_dir>/ckpt``; ``--resume_file`` names such a directory to resume
from (its latest step, or ``--start_step``). ``--bf16_grads`` takes the
gradients in bf16, ``--bf16_adam_state`` stores the Adam moments in bf16.
``--baseline`` pretrains the single-stream baseline
(``models.basebert.BaseBertForPretraining``; ``--from_pretrained`` then maps
reference names as the baseline's), and ``--visual_target 2`` trains the
masked regions by NCE against ``--num_negative`` sampled negatives.
``--remat`` recomputes each encoder block of the two-stream model in the
backward (``torch.utils.checkpoint``) instead of keeping its activations;
the single-stream baseline ignores it, as the JAX one does. On a
CUDA device the model runs the port's attention (forward with dropout,
backward) and LayerNorm kernels, built from ``vilbert_tpu_torch/csrc`` at
first use.

Data parallelism: ``--coordinator host:port --num_processes N
--process_id r`` (or a ``torchrun`` launch, read from its environment)
joins N processes (NCCL on CUDA, gloo on the CPU; ``cuda:<LOCAL_RANK>``
each); each loads shard ``--shard_id`` of ``--num_shards`` (default: its
rank of the world) at ``--batch_size // num_shards`` a step, and rank 0
writes the checkpoints and ``params_final.npz``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/bert_base_6layer_6conect.json")
    p.add_argument("--train_store", default="", help=".vfr/.lmdb region features")
    p.add_argument("--captions", default="", help="caption json {image_id: text}")
    p.add_argument("--val_store", default="", help="validation region features")
    p.add_argument("--val_captions", default="", help="validation caption json")
    p.add_argument("--val_every", type=int, default=0,
                   help="steps between validation passes (0: once at end; "
                        "with --num_epochs, once per epoch)")
    p.add_argument("--vocab", default="", help="WordPiece vocab.txt")
    p.add_argument("--from_pretrained", default="", help="torch .bin or .npz params")
    p.add_argument("--output_dir", default="checkpoints/concap")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--num_steps", type=int, default=0, help="override step count")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--seq_len", type=int, default=36)
    p.add_argument("--region_len", type=int, default=36)
    p.add_argument("--img_weight", type=float, default=1.0)
    p.add_argument("--objective", type=int, default=0)
    p.add_argument("--visual_target", type=int, default=0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--pretrained_lr_scale", type=float, default=1.0)
    p.add_argument("--baseline", action="store_true",
                   help="pretrain the single-stream baseline (reference --baseline)")
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--bf16_adam_state", action="store_true",
                   help="store the Adam moments in bfloat16 (they accumulate in fp32)")
    p.add_argument("--bf16_grads", action="store_true",
                   help="differentiate with respect to bf16 copies of the parameters")
    p.add_argument("--num_negative", type=int, default=128)
    p.add_argument("--freeze", type=int, default=-1,
                   help="freeze text embeddings + text layers 0..N (-1 = nothing)")
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--bert_model", default="bert-base-uncased")
    p.add_argument("--without_coattention", action="store_true")
    p.add_argument("--save_name", default="")
    p.add_argument("--resume_file", default="",
                   help="checkpoint directory to resume (parameters + optimizer state)")
    p.add_argument("--start_step", type=int, default=-1,
                   help="override the resume step (-1: from the checkpoint)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the initial weights and every dropout mask")
    p.add_argument("--shard_id", type=int, default=-1, help="-1: this process's rank")
    p.add_argument("--num_shards", type=int, default=0, help="0: the number of processes")
    p.add_argument("--coordinator", default="",
                   help="host:port of rank 0 for a multi-process run (torch.distributed)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--lm_gather", type=int, default=-1,
                   help="project only K masked positions through the LM head "
                        "(-1: seq_len//3, 0: the full sequence)")
    p.add_argument("--img_gather", type=int, default=0,
                   help="project only K masked regions through the image head")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for flag parity; on CUDA the port always runs its kernels")
    p.add_argument("--remat", action="store_true",
                   help="recompute each encoder block in the backward (activation memory)")
    p.add_argument("--num_workers", type=int, default=0,
                   help=">1: thread-pool host batch building (deterministic)")
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="steps between full-state checkpoints into <output_dir>/ckpt (0: none)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def setup_distributed(args: argparse.Namespace):
    """Join the process group the flags ask for (``--coordinator``,
    ``--num_processes``, ``--process_id``, or ``torchrun``'s environment);
    returns (this rank's device, its data-axis ``Mesh`` or None for a
    single process)."""
    from vilbert_tpu_torch.parallel.distributed import initialize_distributed, is_initialized
    from vilbert_tpu_torch.parallel.mesh import make_mesh

    device = initialize_distributed(
        args.coordinator or None, args.num_processes or None,
        args.process_id if args.process_id >= 0 else None, device=args.device)
    return device, (make_mesh(device=device) if is_initialized() else None)


def finish_distributed(write) -> None:
    """``write()`` on rank 0 (the others wait for it), then leave the
    process group."""
    from vilbert_tpu_torch.parallel.distributed import barrier, process_shard, shutdown_distributed

    if process_shard()[0] == 0:
        write()
    barrier()
    shutdown_distributed()


def model_family(args: argparse.Namespace) -> str:
    return "basebert" if args.baseline else "vilbert"


def synthetic_stores(batch_size: int):
    """The JAX CLI's synthetic CC world: 256 training images (or one batch,
    if larger: the JAX CLI's loader yields nothing there) and 64 validation
    images of 36 boxes, with captions."""
    from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore

    store = InMemoryFeatureStore.synthetic(num_images=max(256, batch_size), num_boxes=36)
    captions = {k: f"a synthetic caption about image {k}" for k in store.keys()}
    val_store = InMemoryFeatureStore.synthetic(num_images=64, num_boxes=36)
    val_captions = {k: f"a synthetic validation caption {k}" for k in val_store.keys()}
    return store, captions, val_store, val_captions


def concap_loader(store, captions, tokenizer, model_cfg: ModelConfig, args, *, seed: int,
                  num_workers: int = 0, shard_id: int = 0, num_shards: int = 1):
    """Shard ``shard_id`` of ``num_shards`` of the CC samples, at
    ``--batch_size // num_shards`` a batch."""
    from vilbert_tpu_torch.data.concap import ConceptCapLoader, ConceptCapSampleConfig

    return ConceptCapLoader(
        store, captions, tokenizer, batch_size=args.batch_size // num_shards,
        cfg=ConceptCapSampleConfig(
            seq_len=args.seq_len, region_len=args.region_len,
            feature_dim=model_cfg.v_feature_size, target_dim=model_cfg.v_target_size,
            visual_target=args.visual_target, objective=args.objective,
        ),
        seed=seed, shard_id=shard_id, num_shards=num_shards, num_workers=num_workers,
    )


def optimizer_config(args: argparse.Namespace, schedule: str = "warmup_linear") -> OptimizerConfig:
    """The CLI's AdamW settings; ``schedule="constant"`` holds the learning
    rate, for timing steps at any step count."""
    moments = "bfloat16" if args.bf16_adam_state else "float32"
    return OptimizerConfig(
        learning_rate=args.learning_rate,
        warmup_proportion=args.warmup_proportion,
        schedule=schedule,
        beta2=0.98,  # reference AdamW betas for concap (train_concap.py:467)
        eps=args.adam_epsilon,
        pretrained_lr_scale=args.pretrained_lr_scale,
        first_moment_dtype=moments,
        second_moment_dtype=moments,
    )


def train(args: argparse.Namespace, hooks: Optional[list] = None):
    """The CLI's body without the final save: data, model and
    ``run_pretraining`` for parsed flags, with the checkpoint hook of
    ``--checkpoint_every`` after ``hooks``; returns the final ``TrainState``.
    A multi-process run joins its process group here and stays in it
    (``finish_distributed`` leaves it)."""
    from vilbert_tpu_torch.parallel.distributed import process_shard

    device, mesh = setup_distributed(args)
    rank, world = process_shard(mesh)
    num_shards = args.num_shards if args.num_shards > 0 else world
    shard_id = args.shard_id if args.shard_id >= 0 else rank
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"--shard_id {shard_id} outside --num_shards {num_shards}")

    from vilbert_tpu_torch.cli.train_tasks import freeze_prefixes
    from vilbert_tpu_torch.data.tokenization import load_tokenizer
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    model_cfg = ModelConfig.from_json_file(
        args.config,
        objective=args.objective,
        visual_target=args.visual_target,
        num_negative=args.num_negative,
        dynamic_attention=args.dynamic_attention,
        with_coattention=not args.without_coattention,
        model="roberta" if "roberta" in args.bert_model else "bert",
        remat=args.remat,
    )
    if args.save_name:
        args.output_dir = os.path.join(args.output_dir, args.save_name)
    tokenizer = load_tokenizer(args.vocab or None, model_cfg.vocab_size)

    val_store = val_captions = None
    if args.synthetic:
        store, captions, val_store, val_captions = synthetic_stores(args.batch_size)
    else:
        from vilbert_tpu_torch.data.feature_store import open_feature_store

        if not (args.train_store and args.captions):
            raise SystemExit("--train_store and --captions are required without --synthetic")
        store = open_feature_store(args.train_store)
        with open(args.captions) as f:
            captions = json.load(f)
        if args.val_store:
            if not args.val_captions:
                raise SystemExit("--val_captions is required with --val_store")
            val_store = open_feature_store(args.val_store)
            with open(args.val_captions) as f:
                val_captions = json.load(f)
    shard = dict(shard_id=shard_id, num_shards=num_shards)
    loader = concap_loader(store, captions, tokenizer, model_cfg, args, seed=args.seed,
                           num_workers=args.num_workers, **shard)
    val_loader = None
    if val_store is not None:
        val_loader = concap_loader(val_store, val_captions, tokenizer, model_cfg, args,
                                   seed=args.seed + 1, **shard)

    steps_per_epoch = max(len(store.keys()) // args.batch_size, 1)
    num_steps = args.num_steps or steps_per_epoch * args.num_epochs
    val_every = args.val_every or (0 if args.num_steps else steps_per_epoch)
    model = None
    if args.from_pretrained:
        import torch

        from vilbert_tpu_torch.core.weights import load_weights
        from vilbert_tpu_torch.train.pretrain import pretrain_model

        model = pretrain_model(model_cfg, model_family(args),
                               generator=torch.Generator().manual_seed(args.seed))
        load_weights(model, args.from_pretrained)

    hooks = list(hooks or ())
    if args.checkpoint_every:
        from vilbert_tpu_torch.core.checkpoint import CheckpointManager
        from vilbert_tpu_torch.parallel.train_step import train_state_dict

        mngr = CheckpointManager(os.path.join(args.output_dir, "ckpt"), mesh=mesh)

        def ckpt_hook(step, state, metrics):
            if (step + 1) % args.checkpoint_every == 0:
                mngr.save(step + 1, train_state_dict(state))

        hooks.append(ckpt_hook)

    return run_pretraining(
        model_cfg, optimizer_config(args), loader, num_steps=num_steps, seed=args.seed,
        img_weight=args.img_weight, grad_accum=args.gradient_accumulation_steps,
        lm_gather=args.seq_len // 3 if args.lm_gather == -1 else args.lm_gather,
        img_gather=args.img_gather, model=model, model_family=model_family(args),
        device=device, mesh=mesh,
        val_loader=val_loader, val_every=val_every, hooks=hooks,
        freeze_prefix=freeze_prefixes(str(args.freeze)),
        resume_dir=args.resume_file, start_step=args.start_step,
        grad_dtype="bfloat16" if args.bf16_grads else "",
    )


def main(argv: Optional[Sequence[str]] = None):
    """Parse the flags, train, write ``params_final.npz``; returns the final
    ``TrainState``."""
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    state = train(args)

    from vilbert_tpu_torch.core.weights import save_params_npz

    path = os.path.join(args.output_dir, "params_final.npz")

    def write():
        save_params_npz(path, state.model)
        logging.info("saved %s", path)

    finish_distributed(write)
    return state


if __name__ == "__main__":
    main()
