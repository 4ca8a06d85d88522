"""End-to-end demo on PyTorch: every task head on one image (mirrors the
root ``demo.py`` of the JAX package and the reference demo.ipynb).

Feature extraction is an offline prerequisite: the demo reads precomputed
region features from a ``.vfr``/``.lmdb`` store, or synthesises them with
``--synthetic``, tokenizes the question, runs one forward with all heads
and prints the VQA and GQA answers, the SNLI-VE probabilities, the
grounded region and the alignment score, in the JAX demo's lines.

  python -m vilbert_tpu_torch.cli.demo --synthetic --question "what is on the table?"
  python -m vilbert_tpu_torch.cli.demo --store feats.vfr --image_id 42 \\
      --params multi_task_model.npz --vocab vocab.txt --question "..."

It runs on the card (the port's attention and LayerNorm kernels) unless
``--device cpu``. ``--int8`` runs every dense site in dynamic int8
(``int8_matmul``, ``ops.quant``), as the JAX demo's flag does.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="configs/bert_base_2layer_2conect.json")
    p.add_argument("--store", default="")
    p.add_argument("--image_id", default="0")
    p.add_argument("--params", default="", help=".npz (flax param paths) or reference .bin")
    p.add_argument("--vocab", default="")
    p.add_argument("--question", default="what is in the image?")
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--max_seq_length", type=int, default=30)
    p.add_argument("--max_region_num", type=int, default=37)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="dynamic int8 inference matmuls (ops/quant.py)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: Optional[Sequence[str]] = None, *, model: Optional[torch.nn.Module] = None):
    """Run the demo and print its lines; returns the heads' outputs.
    ``model`` replaces the one built from ``--config`` and ``--params``."""
    args = build_parser().parse_args(argv)

    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.core.weights import load_weights
    from vilbert_tpu_torch.data.feature_store import (
        InMemoryFeatureStore,
        open_feature_store,
        read_with_global,
    )
    from vilbert_tpu_torch.data.tasks import _pad_text
    from vilbert_tpu_torch.data.tokenization import add_special_single, load_tokenizer
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    cfg = ModelConfig.from_json_file(args.config, int8_matmul=args.int8)
    tokenizer = load_tokenizer(args.vocab or None, cfg.vocab_size)
    store = (InMemoryFeatureStore.synthetic(num_images=4, num_boxes=36)
             if args.synthetic or not args.store else open_feature_store(args.store))

    regions = read_with_global(store.get(args.image_id))
    r = args.max_region_num
    feats = np.zeros((1, r, cfg.v_feature_size), np.float32)
    spats = np.zeros((1, r, 5), np.float32)
    mask = np.zeros((1, r), np.int32)
    n = min(regions.num_boxes, r)
    feats[0, :n] = regions.features[:n]
    spats[0, :n] = regions.locations[:n]
    mask[0, :n] = 1

    ids = add_special_single(
        tokenizer, list(tokenizer.encode(args.question))[: args.max_seq_length - 2])
    q, qm, sg = _pad_text(ids, args.max_seq_length)

    if model is None:
        model = ViLBERTForVLTasks(cfg, generator=torch.Generator().manual_seed(0))
        if args.params:
            load_weights(model, args.params)
        model = model.to(args.device)
    model.eval()
    dev = args.device

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    # custom_prediction: every head at once (reference demo.ipynb cell 4)
    with torch.no_grad():
        out = model(t(q[None]), t(feats), t(spats), t(sg[None]), t(qm[None]), t(mask))

    print(f"question: {args.question!r}  image: {args.image_id}")
    print(f"vqa answer idx:   {int(out.vil_prediction[0].argmax())}")
    print(f"gqa answer idx:   {int(out.vil_prediction_gqa[0].argmax())}")
    tri = torch.softmax(out.vil_tri_prediction[0].float(), dim=-1).cpu().numpy()
    print(f"snli-ve probs:    contradiction {tri[0]:.3f} neutral {tri[1]:.3f} "
          f"entailment {tri[2]:.3f}")
    grounding = out.vision_logit[0, :, 0].float().cpu().numpy()
    best = int(np.argmax(grounding))
    print(f"grounded region:  row {best} (logit {grounding[best]:.3f}) "
          f"box {np.asarray(spats[0, best, :4])}")
    print(f"vil_logit score:  {float(out.vil_logit[0, 0]):.4f}")
    return out


if __name__ == "__main__":
    main()
