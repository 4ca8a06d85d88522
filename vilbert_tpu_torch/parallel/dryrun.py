"""The multi-process dry run: one sharded pretraining step, then one
two-task iteration and an evaluation, over a (data, model) mesh.

Counterpart of ``__graft_entry__.dryrun_multichip`` / ``_dryrun_impl`` /
``_dryrun_multitask`` / ``dryrun_multihost``, on processes joined by
``torch.distributed``::

    python -m vilbert_tpu_torch.parallel.dryrun --processes N \\
        [--model_dim M] [--device cuda|cpu]

It starts N processes (gloo; NCCL where each rank has a card of its own)
forming an (N / M, M) mesh; M is 2 for an even N of at least 4, else 1,
as in the JAX dry run. Phase 1 (``pretrain_step``): the tiny config of
``_dryrun_impl`` at the smallest widths the kernels take
(``dryrun_config``), a global batch of two rows a data row
(``example_batch``), the parameters sharded over "model" by
``param_sharding_rules(min_size_to_shard=1024)``, one pretraining step of
``make_train_step(shard_rules=)`` at a constant 1e-3. Phase 2
(``multitask_iteration``): a VQA-style and a three-way task through
``MultiTaskTrainer(mesh=)``, one round-robin iteration and an evaluation.
Every rank prints ``dryrun_multichip(N): ok, loss=..., mesh={...}`` and
``dryrun_multitask: ok, ...``; the launcher checks that the ranks print the
same lines and prints them once. A failed rank fails the run (exit code 1).
The device defaults to CUDA: every rank on the current card (``cuda:<rank
% cards>``); ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig, TaskConfig
from vilbert_tpu_torch.parallel.mesh import Mesh, make_mesh, param_sharding_rules

#: ``_dryrun_impl``'s model (``__graft_entry__.py:202-210``) at the
#: smallest widths the kernels take (K1: heads of 64; K4: rows of a multiple
#: of 128), where its heads of 16 and rows of 64 have no kernel; the same
#: model on every device, and the JAX comparison builds it too
DRYRUN_CONFIG = dict(
    vocab_size=128, hidden_size=128, num_hidden_layers=4, num_attention_heads=2,
    intermediate_size=256, max_position_embeddings=64, v_feature_size=32, v_hidden_size=128,
    v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=128, v_target_size=16,
    bi_hidden_size=128, bi_num_attention_heads=2, v_biattention_id=(0, 1),
    t_biattention_id=(2, 3), compute_dtype="float32")
SEQ, REGIONS = 12, 6
MIN_SIZE_TO_SHARD = 1024
ROWS_PER_DATA_ROW = 2
NUM_LABELS = 13


def dryrun_config() -> ModelConfig:
    """``DRYRUN_CONFIG``'s model."""
    return ModelConfig(**DRYRUN_CONFIG)


def default_model_dim(processes: int) -> int:
    """The JAX dry run's model axis: 2 for an even count of at least 4."""
    return 2 if processes >= 4 and processes % 2 == 0 else 1


def example_batch(cfg: ModelConfig, batch: int = 2, seq: int = 16,
                  regions: int = 10) -> Dict[str, np.ndarray]:
    """``__graft_entry__._example_batch``: a pretraining batch from
    ``RandomState(0)``, no masked position, every region's label 1."""
    rng = np.random.RandomState(0)
    return {
        "input_ids": rng.randint(1, cfg.vocab_size, (batch, seq)).astype(np.int32),
        "image_feat": rng.randn(batch, regions, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(batch, regions, 5).astype(np.float32),
        "segment_ids": np.zeros((batch, seq), np.int32),
        "input_mask": np.ones((batch, seq), np.int32),
        "image_mask": np.ones((batch, regions), np.int32),
        "lm_label_ids": np.full((batch, seq), -1, np.int32),
        "image_label": np.full((batch, regions - 1), 1, np.int32),
        "image_target": (np.ones((batch, regions - 1, cfg.v_target_size), np.float32)
                         / cfg.v_target_size),
        "is_next": np.zeros((batch,), np.int32),
    }


def pretrain_batch(cfg: ModelConfig, data_size: int) -> Dict[str, np.ndarray]:
    """Phase 1's global batch: two rows a data row, one masked LM position
    a row (``_dryrun_impl``)."""
    batch = example_batch(cfg, batch=ROWS_PER_DATA_ROW * data_size, seq=SEQ, regions=REGIONS)
    batch["lm_label_ids"][:, 1] = 7
    return batch


def data_rows(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: its data row's equal share."""
    n = len(next(iter(batch.values()))) // mesh.data_size
    return {k: v[mesh.data_rank * n:(mesh.data_rank + 1) * n] for k, v in batch.items()}


def pretrain_step(mesh: Mesh, model: Optional[torch.nn.Module] = None, *, seed: int = 0,
                  min_size_to_shard: int = MIN_SIZE_TO_SHARD) -> Tuple[dict, Any, Any]:
    """Phase 1: one pretraining step of ``dryrun_config``'s model (drawn
    from ``seed`` unless given) on this rank's rows of ``pretrain_batch``,
    the update sharded over the model axis. Returns (metrics, model,
    optimizer); the optimizer holds this rank's slices."""
    from vilbert_tpu_torch.data.prefetch import to_device, to_tensors
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

    cfg = dryrun_config()
    if model is None:
        model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(seed))
    model = model.to(mesh.device)
    rules = param_sharding_rules(model, mesh, min_size_to_shard=min_size_to_shard)
    opt, _ = build_optimizer(OptimizerConfig(learning_rate=1e-3, schedule="constant"),
                             dict(model.named_parameters()), 10)
    mesh.replicate(model, opt)
    loss_fn = make_pretrain_loss_fn(cfg, deterministic=True, mesh=mesh)
    step_fn = make_train_step(loss_fn, opt, mesh=mesh, shard_rules=rules)
    batch = to_device(to_tensors(data_rows(pretrain_batch(cfg, mesh.data_size), mesh)),
                      mesh.device)
    metrics = step_fn(model, batch)
    return {k: float(v) for k, v in metrics.items()}, model, opt


class _Loader(list):
    """A list of batches with the ``batch_size`` the trainer's evaluation
    pads to."""

    def __init__(self, batches, batch_size: int):
        super().__init__(batches)
        self.batch_size = batch_size


def multitask_iteration(mesh: Mesh, *, seed: int = 0) -> Tuple[Dict[str, float], dict, Any]:
    """Phase 2 (``_dryrun_multitask``): a VL-classifier and a
    VL-tri-classifier task on ``dryrun_config``, two training batches
    each and one validation batch of the first, global batches of two rows
    a data row from ``RandomState(3)`` of which this rank takes its data
    row's; one round-robin iteration and the first task's evaluation.
    Returns ({task: loss}, the evaluation, the trained model)."""
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    cfg = dryrun_config()
    rng = np.random.RandomState(3)
    b, t, r = ROWS_PER_DATA_ROW * mesh.data_size, SEQ, REGIONS

    def task_batch(kind: str) -> Dict[str, np.ndarray]:
        batch = {
            "question": rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32),
            "features": rng.randn(b, r, cfg.v_feature_size).astype(np.float32),
            "spatials": rng.rand(b, r, 5).astype(np.float32),
            "segment_ids": np.zeros((b, t), np.int32),
            "input_mask": np.ones((b, t), np.int32),
            "image_mask": np.ones((b, r), np.int32),
        }
        batch["target"] = (rng.rand(b, NUM_LABELS).astype(np.float32) if kind == "vqa"
                           else rng.randint(0, 3, (b,)).astype(np.int32))
        return data_rows(batch, mesh)

    local = ROWS_PER_DATA_ROW
    tasks = {
        "TASK_A": TaskConfig(task_id=1, name="A", type="VL-classifier", loss="BCEWithLogitLoss",
                             batch_size=local, lr=4e-5, num_epoch=2, num_labels=NUM_LABELS),
        "TASK_B": TaskConfig(task_id=2, name="B", type="VL-tri-classifier",
                             loss="CrossEntropyLoss", batch_size=local, lr=2e-5, num_epoch=2,
                             num_labels=3),
    }
    loaders = {"TASK_A": _Loader([task_batch("vqa") for _ in range(2)], local),
               "TASK_B": _Loader([task_batch("tri") for _ in range(2)], local)}
    val_loaders = {"TASK_A": _Loader([task_batch("vqa")], local)}
    trainer = MultiTaskTrainer(
        cfg, tasks, loaders, val_loaders=val_loaders, num_labels=NUM_LABELS, seed=seed,
        mesh=mesh, opt_cfg=OptimizerConfig(learning_rate=2e-5, schedule="warmup_linear",
                                           warmup_proportion=0.1, head_lr=1e-4,
                                           correct_bias=False))
    try:
        metrics = trainer.train_iteration(0)
        losses = {k: float(m["loss"]) for k, m in metrics.items()}
        return losses, trainer.evaluate("TASK_A"), trainer.model
    finally:
        trainer.close()


def run_rank(mesh: Mesh, processes: int) -> List[str]:
    """Both phases on this rank; their lines, which every rank must print
    alike."""
    metrics, _, _ = pretrain_step(mesh)
    if not np.isfinite(metrics["loss"]):
        raise FloatingPointError(f"non-finite loss {metrics['loss']}")
    losses, ev, _ = multitask_iteration(mesh)
    if not (all(np.isfinite(v) for v in losses.values())
            and np.isfinite(ev["loss"]) and np.isfinite(ev["score"])):
        raise FloatingPointError(f"non-finite multi-task results {losses} {ev}")
    return [f"dryrun_multichip({processes}): ok, loss={metrics['loss']:.4f}, mesh={mesh.shape}",
            f"dryrun_multitask: ok, losses={ {k: round(v, 4) for k, v in losses.items()} }, "
            f"eval_loss={ev['loss']:.4f}"]


def _worker(args: argparse.Namespace) -> int:
    from vilbert_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed

    if args.device == "cpu":
        torch.set_num_threads(1)
    backend = ("nccl" if args.device == "cuda" and args.processes <= torch.cuda.device_count()
               else "gloo")
    device = initialize_distributed(f"localhost:{args.port}", args.processes, args.worker,
                                    device=args.device, backend=backend)
    if device.type == "cuda":
        from vilbert_tpu_torch.ops import _build

        _build.load_library()
    try:
        mesh = make_mesh((args.processes // args.model_dim, args.model_dim), ("data", "model"),
                         device=device)
        for line in run_rank(mesh, args.processes):
            print(f"RANK{args.worker} {line}", flush=True)
    finally:
        shutdown_distributed()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(processes: int, model_dim: int, device: str, timeout: float = 1200) -> List[str]:
    """Run the dry run in ``processes`` new processes; returns the lines
    every rank printed alike. Raises RuntimeError if a rank fails or the
    ranks disagree."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vilbert_tpu_torch.parallel.dryrun", "--processes",
         str(processes), "--model_dim", str(model_dim), "--device", device,
         "--worker", str(rank), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
        for rank in range(processes)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"rank {rank} failed (exit {proc.returncode}):\n{log[-4000:]}")
    lines = [[ln.split(" ", 1)[1] for ln in log.splitlines() if ln.startswith(f"RANK{rank} ")]
             for rank, log in enumerate(logs)]
    if len(lines[0]) != 2 or any(other != lines[0] for other in lines[1:]):
        raise RuntimeError(f"the ranks printed different results: {lines}")
    return lines[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processes", type=int, required=True, help="ranks of the mesh")
    p.add_argument("--model_dim", type=int, default=0,
                   help="size of the model axis (default: 2 for an even count >= 4, else 1)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    args.model_dim = args.model_dim or default_model_dim(args.processes)
    if args.processes < 1 or args.processes % args.model_dim:
        parser.error(f"{args.processes} processes do not form a model axis of {args.model_dim}")
    if args.worker >= 0:
        return _worker(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    try:
        lines = launch(args.processes, args.model_dim, args.device)
    except RuntimeError as e:
        print(f"dryrun failed: {e}", file=sys.stderr)
        return 1
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
