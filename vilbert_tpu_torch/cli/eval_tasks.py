"""CLI: per-task evaluation + submission files on PyTorch (mirrors the
reference eval_tasks.py and ``vilbert_tpu.cli.eval_tasks``).

  python -m vilbert_tpu_torch.cli.eval_tasks \\
      --config configs/bert_base_6layer_6conect.json \\
      --tasks_yml configs/tasks.yml --tasks 1 \\
      --params checkpoints/multitask/params_final.npz --output_dir results/

  # smoke test without data artifacts: --synthetic

Writes, per task, ``metrics_<task>_<split>.json`` and
``<task>_<split>_result.json`` into ``--output_dir``. ``--baseline``
evaluates the single-stream baseline (``models.basebert.BaseBertForVLTasks``);
``--int8`` runs every dense site in dynamic int8 (``int8_matmul``,
``ops.quant``) as the JAX CLI's flag does.
On a CUDA device the attention and LayerNorm of the model run the port's
kernels, built from ``vilbert_tpu_torch/csrc`` at first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch import nn

from vilbert_tpu_torch.core.config import ModelConfig, TaskConfig
from vilbert_tpu_torch.core.weights import load_weights
from vilbert_tpu_torch.eval.evaluators import evaluate_task, save_results
from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks
from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/bert_base_6layer_6conect.json")
    p.add_argument("--tasks_yml", default="configs/tasks.yml")
    p.add_argument("--tasks", default="1")
    p.add_argument("--params", default="",
                   help=".npz (flax param paths) or reference torch .bin checkpoint")
    p.add_argument("--vocab", default="",
                   help="WordPiece vocab.txt (required for real data)")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--split", default="val")
    p.add_argument("--task_specific_tokens", action="store_true")
    p.add_argument("--dynamic_attention", action="store_true")
    p.add_argument("--baseline", action="store_true",
                   help="evaluate the single-stream baseline (reference eval_tasks.py --baseline)")
    p.add_argument("--batch_size", type=int, default=0,
                   help="override the per-task eval batch size")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 matmuls for inference (ops/quant.py)")
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for flag parity; on CUDA the port always "
                        "runs its attention and LayerNorm kernels")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--seed", type=int, default=0,
                   help="initialisation seed for weights not in --params")
    return p


def build_model(
    model_cfg: ModelConfig, *, params: str = "", seed: int = 0, device: str = "cuda",
    baseline: bool = False,
) -> nn.Module:
    """The VL-tasks model (the single-stream baseline's with ``baseline``),
    seeded, with ``params`` loaded, on ``device``, in eval."""
    cls = BaseBertForVLTasks if baseline else ViLBERTForVLTasks
    model = cls(model_cfg, generator=torch.Generator().manual_seed(seed))
    if params:
        load_weights(model, params)
    return model.to(device).eval()


def run_eval(
    model: nn.Module,
    model_cfg: ModelConfig,
    tasks: Mapping[str, TaskConfig],
    loaders: Mapping[str, Iterable],
    *,
    output_dir: str = "results",
    split: str = "val",
    label2ans: Optional[Mapping[str, Optional[List[str]]]] = None,
) -> Dict[str, Tuple[Dict[str, float], List[dict]]]:
    """Evaluate every task; write its metrics and submission files.

    Returns {task key: (metrics, records)}.
    """
    out = {}
    for key, task in tasks.items():
        metrics, results = evaluate_task(
            model, model_cfg, task, loaders[key],
            label2ans=(label2ans or {}).get(key),
            qid_map=getattr(getattr(loaders[key], "dataset", None), "qid_map", None),
        )
        logging.info("%s: loss %.4f score %.4f (%d samples)", key,
                     metrics["loss"], metrics["score"], metrics["num_samples"])
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, f"metrics_{task.name}_{split}.json"), "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
        if results:
            logging.info("wrote %s", save_results(results, output_dir, task.name, split))
        out[key] = (metrics, results)
    return out


def synthetic_vqa_loader(model_cfg: ModelConfig, task: TaskConfig, *, num: int = 96,
                         batch_size: int = 64):
    """Synthetic VQA questions at the task's full geometry: images of
    ``max_region_num - 1`` boxes plus the global row, questions of
    ``max_seq_length`` tokens, 3129 answer labels."""
    from vilbert_tpu_torch.data import synthetic as syn
    from vilbert_tpu_torch.data.tasks import DataLoader, VQADataset
    from vilbert_tpu_torch.data.tokenization import HashTokenizer

    store = syn.synthetic_store(num_images=16, num_boxes=task.max_region_num - 1,
                                feature_dim=model_cfg.v_feature_size)
    ds = VQADataset(syn.vqa_annotations(num=num, num_labels=3129), store, num_labels=3129,
                    tokenizer=HashTokenizer(model_cfg.vocab_size),
                    max_seq_length=task.max_seq_length, max_region_num=task.max_region_num)
    return DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False)


def _label2ans(task: TaskConfig) -> Optional[List[str]]:
    """Answer vocabulary for VQA/GQA submission records, if on disk."""
    if task.type not in ("VL-classifier", "VL-classifier-GQA"):
        return None
    from vilbert_tpu_torch.data.annotations import load_label2ans

    try:
        return load_label2ans(task.dataroot)
    except (FileNotFoundError, OSError):
        logging.warning("%s: no cache/trainval_label2ans.pkl under %r — submission "
                        "records will carry integer labels", task.name, task.dataroot)
        return None


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from vilbert_tpu_torch.core.config import load_task_configs

    model_cfg = ModelConfig.from_json_file(
        args.config,
        task_specific_tokens=args.task_specific_tokens,
        dynamic_attention=args.dynamic_attention,
        int8_matmul=args.int8,
    )
    all_tasks = load_task_configs(args.tasks_yml)
    selected = {f"TASK{n}": all_tasks[f"TASK{n}"] for n in args.tasks.split("-")}
    if args.batch_size:
        selected = {k: dataclasses.replace(t, eval_batch_size=args.batch_size)
                    for k, t in selected.items()}

    if args.synthetic:
        from vilbert_tpu_torch.cli.train_tasks import _synthetic_world

        loaders = _synthetic_world(selected, model_cfg.vocab_size)
        label2ans = {}
    else:
        from vilbert_tpu_torch.data.loading import load_datasets
        from vilbert_tpu_torch.data.tokenization import load_tokenizer

        if not args.vocab:
            raise SystemExit(
                "--vocab is required with real data: without the WordPiece vocab, "
                "questions would be tokenized by the synthetic HashTokenizer")
        tokenizer = load_tokenizer(args.vocab, model_cfg.vocab_size)
        _, loaders = load_datasets(selected, tokenizer, with_val=True)
        label2ans = {k: _label2ans(t) for k, t in selected.items()}

    model = build_model(model_cfg, params=args.params, seed=args.seed, device=args.device,
                        baseline=args.baseline)
    run_eval(model, model_cfg, selected, loaders, output_dir=args.output_dir,
             split=args.split, label2ans=label2ans)


if __name__ == "__main__":
    main()
