"""CLI: image-text retrieval ranking on PyTorch (mirrors the reference
eval_retrieval.py and ``vilbert_tpu.cli.eval_retrieval``).

  python -m vilbert_tpu_torch.cli.eval_retrieval \\
      --config configs/bert_base_6layer_6conect.json \\
      --store data/coco_val.vfr --annotations data/coco_val.jsonline \\
      --vocab data/vocab.txt --params multi_task_model.npz --fast_mode
  ... --zero_shot --params pretrained_model.npz   # alignment-score mode

  # smoke test without data artifacts, on the CPU:
  python -m vilbert_tpu_torch.cli.eval_retrieval --synthetic --device cpu

Writes the metrics (r1, r5, r10, medr, meanr, num_captions, pool_size) as
JSON to ``--output``. ``--baseline`` scores with the single-stream baseline
(``BaseBertForPretraining`` under ``--zero_shot``, ``BaseBertForVLTasks``
otherwise). The baseline has no text stream to run once: ``--baseline
--fast_mode`` without ``--zero_shot`` raises a ValueError (the JAX CLI fails
on it when it concatenates a caption at batch 1 with the image chunk),
and zero-shot ignores ``--fast_mode`` in both. On a CUDA device the model
runs the port's attention and LayerNorm kernels, built from
``vilbert_tpu_torch/csrc`` at first use.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/bert_base_6layer_6conect.json")
    p.add_argument("--store", default="")
    p.add_argument("--annotations", default="",
                   help="reference val jsonlines ({id|img_path, sentences: [5 captions]}): "
                        "the published protocol, all 5N captions against the N-image pool")
    p.add_argument("--task_name", default="RetrievalCOCO",
                   choices=["RetrievalCOCO", "RetrievalFlickr30k"])
    p.add_argument("--captions", default="",
                   help="legacy {image_id: caption} json: ONE caption per image; not "
                        "comparable to published R@K (use --annotations)")
    p.add_argument("--vocab", default="")
    p.add_argument("--params", default="", help=".npz (flax param paths) or reference .bin")
    p.add_argument("--zero_shot", action="store_true")
    p.add_argument("--baseline", action="store_true",
                   help="score with the single-stream baseline (reference eval_retrieval.py "
                        "--baseline)")
    p.add_argument("--pool_size", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=500)
    p.add_argument("--max_seq_length", type=int, default=30)
    p.add_argument("--max_region_num", type=int, default=101)
    p.add_argument("--output", default="retrieval_result.json")
    p.add_argument("--fast_mode", action="store_true",
                   help="run the text stream once per caption and broadcast it over the "
                        "image chunk inside the encoder")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def load_pool(store, keys, max_region_num: int, feature_size: int) -> Dict[str, np.ndarray]:
    """The image pool on the host: each image's regions with its global row
    first, zero-padded to ``max_region_num``."""
    from vilbert_tpu_torch.data.feature_store import read_with_global

    feats = np.zeros((len(keys), max_region_num, feature_size), np.float32)
    spats = np.zeros((len(keys), max_region_num, 5), np.float32)
    masks = np.zeros((len(keys), max_region_num), np.int32)
    for i, k in enumerate(keys):
        out = read_with_global(store.get(k))
        n = min(out.num_boxes, max_region_num)
        feats[i, :n] = out.features[:n]
        spats[i, :n] = out.locations[:n]
        masks[i, :n] = 1
    return {"features": feats, "spatials": spats, "image_mask": masks}


def select(args: argparse.Namespace):
    """(store, pool keys, [(caption text, image id)]) for the flags: the
    synthetic pool (8 images, 5 captions each, chunk 4), the annotations'
    protocol or the legacy one-caption-per-image json."""
    if args.synthetic:
        from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore

        store = InMemoryFeatureStore.synthetic(num_images=8, num_boxes=8)
        keys = store.keys()
        caption_entries = [(f"synthetic caption {j} for image {k}", k)
                           for k in keys for j in range(5)]
        args.pool_size, args.chunk = 8, 4
        args.max_region_num = 10
    elif args.annotations:
        from vilbert_tpu_torch.data.annotations import load_retrieval
        from vilbert_tpu_torch.data.feature_store import open_feature_store

        if not args.store:
            raise SystemExit("--store is required")
        store = open_feature_store(args.store)
        anns = load_retrieval(args.annotations, args.task_name)
        available = set(store.keys())
        keys, seen = [], set()
        for a in anns:
            if a.image_id not in seen and a.image_id in available:
                seen.add(a.image_id)
                keys.append(a.image_id)
        keys = keys[: args.pool_size]
        kept = set(keys)
        caption_entries = [(a.text, a.image_id) for a in anns if a.image_id in kept]
    else:
        from vilbert_tpu_torch.data.feature_store import open_feature_store

        if not (args.store and args.captions):
            raise SystemExit("--store plus --annotations (protocol) or --captions (legacy)")
        store = open_feature_store(args.store)
        with open(args.captions) as f:
            captions = json.load(f)
        keys = store.keys()[: args.pool_size]
        caption_entries = [(captions[k], k) for k in keys]
        logging.warning("--captions gives ONE caption per image; published COCO/Flickr R@K "
                        "uses 5 per image: pass --annotations for the real protocol")

    return store, keys, caption_entries


def run(args: argparse.Namespace, *, store=None, keys=None, caption_entries=None,
        model: Optional[torch.nn.Module] = None) -> Dict[str, float]:
    """The CLI's body: returns the metrics and writes them to ``--output``.
    ``store``, ``keys`` and ``caption_entries`` ([(text, image id)]) replace
    the data the flags name; ``model`` replaces the one built from the
    flags (it must match ``--zero_shot`` and ``--fast_mode``)."""
    if args.baseline and args.fast_mode and not args.zero_shot:
        raise ValueError(
            "--baseline --fast_mode: the single-stream baseline has no text stream to run "
            "once per caption; run it without --fast_mode")

    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.tasks import _pad_text
    from vilbert_tpu_torch.data.tokenization import add_special_single, load_tokenizer
    from vilbert_tpu_torch.eval.retrieval import (
        evaluate_retrieval,
        make_alignment_scorer,
        make_vil_logit_scorer,
    )

    # fast_mode broadcasts one caption over the image chunk inside the
    # encoder (reference eval_retrieval.py:220, vilbert.py:1042-1053)
    model_cfg = ModelConfig.from_json_file(args.config, fast_mode=args.fast_mode)
    tokenizer = load_tokenizer(args.vocab or None, model_cfg.vocab_size)
    if store is None:
        store, keys, caption_entries = select(args)
    pool = load_pool(store, keys, args.max_region_num, model_cfg.v_feature_size)
    pool_index = {k: i for i, k in enumerate(keys)}

    def caption_iter():
        for text, image_id in caption_entries:
            ids = add_special_single(
                tokenizer, list(tokenizer.encode(text))[: args.max_seq_length - 2])
            q, m, s = _pad_text(ids, args.max_seq_length)
            yield {"question": q, "input_mask": m, "segment_ids": s,
                   "target_index": pool_index[image_id]}

    if model is None:
        from vilbert_tpu_torch.core.weights import load_weights
        from vilbert_tpu_torch.models.basebert import BaseBertForPretraining, BaseBertForVLTasks
        from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks

        cls = {(False, True): ViLBERTForPretraining, (False, False): ViLBERTForVLTasks,
               (True, True): BaseBertForPretraining,
               (True, False): BaseBertForVLTasks}[args.baseline, args.zero_shot]
        model = cls(model_cfg, generator=torch.Generator().manual_seed(0))
        if args.params:
            load_weights(model, args.params)
        model = model.to(args.device)
    scorer = make_alignment_scorer(model) if args.zero_shot else make_vil_logit_scorer(model)
    metrics = evaluate_retrieval(scorer, caption_iter(), pool, chunk=args.chunk,
                                 fast_mode=args.fast_mode and not args.zero_shot,
                                 device=args.device)
    metrics["num_captions"] = len(caption_entries)
    metrics["pool_size"] = len(keys)
    logging.info("retrieval: %s", metrics)
    with open(args.output, "w") as f:
        json.dump(metrics, f)
    return metrics


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    logging.basicConfig(level=logging.INFO)
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
