#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's paths, on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/profile_torch.py [--out profile.json] [--paths vqa,cc,multitask]
    python3 scripts/profile_torch.py --paths base_vqa,base_cc,base_multitask,nce_cc
    python3 scripts/profile_torch.py --paths vqa,int8_vqa,static_vqa,maps_vqa,cc,remat_cc

At the full width of configs/bert_base_6layer_6conect.json, weights from
seed 0, bf16 compute, it profiles with ``torch.profiler`` (CPU and CUDA
activities) after warm-up:

- the VQA forward (head ``vil_prediction``) at B=1024, T=23, R=101;
- the CC pretraining step (forward, losses, backward, AdamW) at B=256,
  T=36, R=37, dropout 0.1, lm_gather 12, one batch held on the card;
- one round-robin iteration of the multi-task trainer on the flagship
  recipe (chip_smoke.py's twelve tasks and synthetic loaders, task tokens,
  dropout 0.1), through the host loader;
- with ``--paths base_vqa,base_cc,base_multitask,nce_cc``: the same three
  for the single-stream baseline at configs/bert_base_baseline.json (the
  iteration over the nine flagship tasks it has heads for, no task token),
  and the two-stream CC step with NCE (visual target 2);
- with ``--paths int8_vqa,static_vqa,maps_vqa,remat_cc``: the model
  options, the VQA forward with dynamic int8 (``int8_matmul``), with static
  int8 (``int8_static``, calibrated on 64 samples as bench.py:66-78 does)
  and with the attention maps (``visualization``), and the CC step with
  ``remat``.

For each it prints the untraced time of one forward or step (host clock
around work that ends in a synchronize), the device time per forward or
step summed over the profiled kernels, the idle share (1 - device time over
the untraced time), the peak device memory, and the device time by kernel
class and by kernel name. The classes are read from kernel names, so they
are coarse: the port's own kernels, cuBLAS GEMMs, elementwise, reductions,
copies, optimizer, indexing. It imports only the port; the batches are
those of chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = "configs/bert_base_6layer_6conect.json"

#: (class, substrings of the kernel name), first match wins
CLASSES = (
    ("K1 attention forward, tensor cores", ("attention_fwd_tc",)),
    ("K1 attention forward, long, tensor cores", ("attention_fwd_long_tc",)),
    ("K1 attention forward, wgmma", ("attention_fwd_wg",)),
    ("K1 attention forward, CUDA cores", ("attention_fwd",)),
    ("K2 attention backward, tensor cores", ("attention_bwd_tc",)),
    ("K2 attention backward, wgmma", ("attention_bwd_wg",)),
    ("K2 attention backward, long, tensor cores", ("attention_bwd_long_tc",)),
    ("K2 attention backward, long, CUDA cores", ("attention_bwd_rows_dq", "attention_bwd_dkdv")),
    ("K2 attention backward, CUDA cores", ("attention_bwd",)),
    ("K4 LayerNorm forward", ("layer_norm_fwd_kernel",)),
    # torch._int_mm on an H100 runs CUTLASS's sm80 int8 kernel
    # (cutlass_80_tensorop_i16832gemm_s8_...)
    ("int8 GEMMs (torch._int_mm)", ("gemm_s8", "s8s8", "imma")),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("Adam and grad norm (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "cast")),
    ("index, embedding, sort", ("index", "embedding", "sort", "gather", "scatter", "radix")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def profile(fn, n: int, warmup: int = 3) -> dict:
    """Untraced ms per call, then the profiler's device kernels per call."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.reset_peak_memory_stats()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_name, launches = defaultdict(float), defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.device_time_total / 1e3 / n  # ms per call
            launches[ev.name] += 1
    by_class, class_launches = defaultdict(float), defaultdict(int)
    for name, ms in by_name.items():
        by_class[kernel_class(name)] += ms
        class_launches[kernel_class(name)] += launches[name]
    device_ms = sum(by_name.values())
    return {
        "untraced_ms": untraced_ms, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / untraced_ms, "peak_memory_gb": peak_gb,
        "launches_per_call": sum(launches.values()) / n,
        "by_class": {k: {"ms": v, "share": v / device_ms, "launches": class_launches[k] / n}
                     for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": k[:120], "ms": v, "launches": launches[k] / n}
                        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
    }


def report(title: str, res: dict, card: str) -> None:
    print(f"== {title} [{card}]")
    print(f"  untraced {res['untraced_ms']:.2f} ms, device kernels {res['device_ms']:.2f} ms, "
          f"idle share {res['idle_share']:.3f}, peak memory {res['peak_memory_gb']:.2f} GB, "
          f"{res['launches_per_call']:.0f} launches")
    for label, row in res["by_class"].items():
        print(f"  {label:32s} {row['ms']:9.3f} ms {row['share']:7.1%} {row['launches']:8.0f}")
    print("  top kernels:")
    for row in res["top_kernels"]:
        print(f"    {row['ms']:9.3f} ms {row['launches']:6.0f}x  {row['name']}")


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="also write the numbers here as JSON")
    p.add_argument("--calls", type=int, default=3, help="forwards or steps profiled")
    p.add_argument("--paths", default="vqa,cc,multitask",
                   help="comma-separated: vqa, cc, multitask (one iteration profiled), "
                        "base_vqa, base_cc, base_multitask, nce_cc, int8_vqa, static_vqa, "
                        "maps_vqa, remat_cc")
    args = p.parse_args(argv)
    paths = set(args.paths.split(","))
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as smoke
    from vilbert_tpu_torch.cli.eval_tasks import build_model
    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.ops.quant import calibrating
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn, pretrain_model

    card = smoke.card_line()
    out = {"card": card}
    for name, config, baseline, option in (
            ("vqa", CONFIG, False, None), ("base_vqa", smoke.BASELINE_CONFIG, True, None),
            ("int8_vqa", CONFIG, False, "int8_matmul"),
            ("static_vqa", CONFIG, False, "int8_static"),
            ("maps_vqa", CONFIG, False, "visualization")):
        if name not in paths:
            continue
        cfg = ModelConfig.from_json_file(config, **({option: True} if option else {}))
        model = build_model(cfg, seed=smoke.SEED, device="cuda", baseline=baseline)
        x = smoke.random_batch(cfg, smoke.TIME_BATCH, smoke.SEED + 2)
        if option == "int8_static":
            with torch.inference_mode(), calibrating(model):
                model(**smoke.random_batch(cfg, smoke.INT8_CALIB_BATCH, smoke.SEED + 30),
                      heads=("vil_prediction",))
        with torch.inference_mode():
            out[f"{name}_forward"] = profile(lambda: model(**x, heads=("vil_prediction",)),
                                             args.calls)
        report(f"{name} forward B={smoke.TIME_BATCH} T={smoke.T} R={smoke.R} bf16",
               out[f"{name}_forward"], card)
        del model, x

    for name, config, family, visual_target in (
            ("cc", CONFIG, "vilbert", 0), ("base_cc", smoke.BASELINE_CONFIG, "basebert", 0),
            ("nce_cc", CONFIG, "vilbert", 2), ("remat_cc", CONFIG, "vilbert", 0)):
        if name not in paths:
            continue
        cfg = ModelConfig.from_json_file(config, visual_target=visual_target,
                                         remat=name == "remat_cc")
        train_args = build_parser().parse_args(["--synthetic", "--config", config])
        generator = torch.Generator().manual_seed(smoke.SEED)
        model = pretrain_model(cfg, family, generator=generator).to("cuda").train()
        opt, _ = build_optimizer(optimizer_config(train_args, schedule="constant"),
                                 dict(model.named_parameters()), 1000, family=model.family)
        step = make_train_step(make_pretrain_loss_fn(cfg, lm_gather=smoke.LM_GATHER,
                                                     nce_generator=generator), opt)
        b = smoke.bench_batch(cfg, smoke.TRAIN_BATCH, smoke.SEED + 6)
        if visual_target:  # NCE scores the region features
            b["image_target"] = b["image_feat"][:, 1:].copy()
        batch = to_device(host_batch(b, cfg), "cuda")
        set_dropout_generator(model, generator)
        out[f"{name}_step"] = profile(lambda: float(step(model, batch)["loss"]), args.calls)
        report(f"{name} step B={smoke.TRAIN_BATCH} T={smoke.TRAIN_T} R={smoke.TRAIN_R} bf16",
               out[f"{name}_step"], card)
        del model, opt, step, batch

    for name in ("multitask", "base_multitask"):
        if name not in paths:
            continue
        import tempfile

        from vilbert_tpu_torch.cli.train_tasks import build_parser as tasks_parser
        from vilbert_tpu_torch.cli.train_tasks import train

        baseline = name == "base_multitask"
        tasks = smoke.baseline_tasks() if baseline else smoke.flagship_tasks()
        loaders, _ = smoke.multitask_loaders(tasks, 30522)
        with tempfile.TemporaryDirectory() as tmp:
            if baseline:
                targs = tasks_parser().parse_args([
                    "--config", smoke.BASELINE_CONFIG, "--baseline", "--lr_scheduler",
                    "mannul", "--head_lr", "1e-4", "--seed", str(smoke.SEED),
                    "--num_iterations", "1", "--output_dir", tmp])
            else:
                targs = smoke.multitask_args(tmp, ["--num_iterations", "1"])
            trainer = train(targs, tasks, loaders)
            out[f"{name}_iteration"] = profile(
                lambda: trainer.train_iteration(trainer.global_step), 1, warmup=1)
        report(f"{name} iteration, {len(tasks)} flagship tasks, bf16",
               out[f"{name}_iteration"], card)
        del trainer
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
