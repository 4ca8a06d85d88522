#!/usr/bin/env python3
"""What the staging thread meets on one card: reproducibility and the GIL.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/probe_prefetch.py

At the full width of configs/bert_base_6layer_6conect.json (bf16, dropout
0.1, weights from seed 0), on one batch of 256 from the synthetic
Conceptual Captions loader:

1. the pretraining loss's backward three times from one state and one
   dropout seed: which parameters' gradients differ between the passes,
   with ``torch.use_deterministic_algorithms`` off and on (a run repeats
   bit for bit only where none does, which the bit-equality of
   chip_smoke.py's phase 22 across prefetch depths needs);
2. the CC driver (``run_pretraining`` over that loader, chip_smoke.py's
   ``cc_driver``) at prefetch depths 0 and 2 under the interpreter's
   default GIL switch interval and at 0.5 and 0.1 ms, alternated: ms a
   step, samples/s, device ms a step and the idle share. A loader thread
   that holds the GIL through its batch delays the main thread's launches;
   a shorter switch interval hands the GIL back sooner, at the cost of
   more switches.

Every line names the card and its power limit. It imports only the port.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_prefetch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from vilbert_tpu_torch.cli.train_concap import build_parser, concap_loader, synthetic_stores
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.data.tokenization import load_tokenizer
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn, pretrain_model

    card = smoke.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    batch_size = smoke.TRAIN_BATCH
    args = build_parser().parse_args(["--synthetic", "--config", smoke.CONFIG, "--batch_size",
                                      str(batch_size)])
    cfg = ModelConfig.from_json_file(smoke.CONFIG)
    store, captions, _, _ = synthetic_stores(batch_size)
    tokenizer = load_tokenizer(None, cfg.vocab_size)

    def make_loader():
        return concap_loader(store, captions, tokenizer, cfg, args, seed=smoke.SEED)

    batch = to_device(host_batch(next(iter(make_loader())), cfg), "cuda")
    model = pretrain_model(cfg, generator=torch.Generator().manual_seed(smoke.SEED)).cuda()
    loss_fn = make_pretrain_loss_fn(cfg, lm_gather=smoke.LM_GATHER)
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        grads = []
        for _ in range(3):
            set_dropout_generator(model, torch.Generator().manual_seed(smoke.SEED + 5))
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch)
            loss.backward()
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None})
        differ = sorted(n for n in grads[0] if not all(torch.equal(grads[0][n], g[n])
                                                        for g in grads[1:]))
        print(f"deterministic algorithms {deterministic}: {len(differ)} of {len(grads[0])} "
              f"gradients differ between 3 backward passes {differ[:10]} [{card}]", flush=True)
    torch.use_deterministic_algorithms(False)
    del model, grads, batch
    torch.cuda.empty_cache()

    model = pretrain_model(cfg, generator=torch.Generator().manual_seed(smoke.SEED))
    default = sys.getswitchinterval()
    runs = [(0, default), (2, default), (2, 5e-4), (2, 1e-4), (2, 1e-4), (2, 5e-4),
            (2, default), (0, default)]
    try:
        for depth, interval in runs:
            sys.setswitchinterval(interval)
            r = smoke.cc_driver(cfg, args, model, make_loader, depth)
            print(f"CC driver B={batch_size}, depth {depth}, switch interval "
                  f"{interval * 1e3:.1f} ms: {r['step_ms']:.2f} ms/step, "
                  f"{r['samples_per_s']:.1f} samples/s, device {r['device_ms']:.2f} ms/step, "
                  f"idle share {r['idle_share']:.3f} [{card}]", flush=True)
    finally:
        sys.setswitchinterval(default)
    return 0


if __name__ == "__main__":
    sys.exit(main())
