#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (vilbert_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from vilbert_tpu_torch/csrc and drives the
port's VQA evaluation path (TASK1 of configs/tasks.yml) at the full width of
configs/bert_base_6layer_6conect.json, weights drawn from a seed:

1. device: the card's name and power limit; TF32 off for fp32 comparisons;
2. build: nvcc for sm_90a, timed;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at the slice's shapes and the edges of its range (fp32 bound 1e-4
   absolute; bf16 bound 2^-7 * max|ref| plus one bf16 ulp);
4. slice: ``run_eval`` (the CLI's function) on synthetic TASK1 at T=23,
   R=101, with the kernels' launch counters reset just before and read just
   after; then a batch of 256 through the kernels and through the plain ops,
   fp32 logits within 1e-3 and bf16 logits finite and within 5e-2;
5. timing: eval questions/s of the forward at B=1024 in bf16 (kernels and
   plain ops), and each kernel against its plain version at the slice's
   shapes.

The last three lines are the card line, a JSON object of the kernels and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
them. Without a CUDA device, or outside a checkout, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

CONFIG = "configs/bert_base_6layer_6conect.json"
SEED = 0
T, R = 23, 101  # reference eval geometry of TASK1 (configs/tasks.yml)
DEVICE = "cuda"
CHECK_BATCH = 256  # kernels vs plain ops, whole model
TIME_BATCH = 1024  # TASK1's eval batch size


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Checks:
    """Collects failed checks; a phase ends by raising on any."""

    def __init__(self):
        self.failed = []

    def expect(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failed.append(what)

    def end_phase(self, name: str) -> None:
        if self.failed:
            raise SystemExit(f"chip_smoke: phase {name} failed: {self.failed}")


def bf16_bound(ref) -> float:
    m = float(ref.abs().max())
    ulp = 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0
    return 2.0 ** -7 * m + ulp


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(kernel_fn, plain_fn) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_time_ms(plain_fn)
    k1 = cuda_time_ms(kernel_fn)
    k2 = cuda_time_ms(kernel_fn)
    p2 = cuda_time_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


# -- phase 3 -----------------------------------------------------------------

#: (heads, head_dim, Sq, Sk): the slice's four kinds of attention (also at
#: T=24, with --task_specific_tokens), Sk=1 and the Sk=512 end of the range
ATTENTION_CASES = [
    (12, 64, 23, 23), (12, 64, 24, 24), (8, 128, 101, 101), (8, 128, 23, 101),
    (8, 128, 101, 23), (8, 128, 24, 101), (8, 128, 101, 24), (8, 128, 23, 1),
    (8, 128, 101, 512), (12, 64, 23, 512),
]
LN_WIDTHS = (768, 1024, 2048)
LN_ROWS = 8 * 101 + 3  # not a multiple of any block


def phase_kernels(checks: Checks) -> dict:
    import torch

    from vilbert_tpu_torch.ops.attention import attention, attention_ref, make_additive_mask
    from vilbert_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    dev = DEVICE
    err = {"attention": 0.0, "layer_norm": 0.0}
    B = 8
    for heads, d, sq, sk in ATTENTION_CASES:
        hd = heads * d
        lengths = torch.randint(1, sk + 1, (B,), generator=g, device=dev)
        lengths[0] = sk
        mask = (torch.arange(sk, device=dev)[None] < lengths[:, None]).int()
        mask[B - 1] = 0  # a fully padded row
        bias = make_additive_mask(mask)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, s, hd, generator=g, device=dev).to(dtype)
                       for s in (sq, sk, sk))
            got = attention(q, k, v, bias, num_heads=heads)
            want = attention_ref(q, k, v, bias, num_heads=heads)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            bound = 1e-4 if dtype == torch.float32 else bf16_bound(want.float())
            err["attention"] = max(err["attention"], e)
            checks.expect(e <= bound, f"attention h={heads} d={d} Sq={sq} Sk={sk} "
                                      f"{str(dtype)[6:]}: max|err| {e:.3e} <= {bound:.3e}")
    for h in LN_WIDTHS:
        w = 1 + 0.1 * torch.randn(h, generator=g, device=dev)
        b = 0.1 * torch.randn(h, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = (2 * torch.randn(LN_ROWS, h, generator=g, device=dev) + 0.5).to(dtype)
            res = torch.randn(LN_ROWS, h, generator=g, device=dev).to(dtype)
            for r in (None, res):
                got = layer_norm(x, w, b, residual=r)
                want = layer_norm_ref(x, w, b, residual=r)
                torch.cuda.synchronize()
                e = float((got.float() - want.float()).abs().max())
                bound = 1e-4 if dtype == torch.float32 else bf16_bound(want.float())
                err["layer_norm"] = max(err["layer_norm"], e)
                checks.expect(e <= bound, f"layer_norm H={h} rows={LN_ROWS} "
                                          f"residual={r is not None} {str(dtype)[6:]}: "
                                          f"max|err| {e:.3e} <= {bound:.3e}")
    checks.end_phase("kernels")
    return err


# -- phase 4 -----------------------------------------------------------------

def task1():
    """TASK1 of configs/tasks.yml (built here: the card has no PyYAML)."""
    from vilbert_tpu.core.config import TaskConfig

    return TaskConfig(task_id=1, name="VQA", type="VL-classifier", loss="BCEWithLogitLoss",
                      dataroot="datasets/VQA/", max_seq_length=T, max_region_num=R,
                      batch_size=128, eval_batch_size=1024, train_split="trainval",
                      val_split="minval", lr=4e-5, num_epoch=20)


def synthetic_task1_loader(cfg, task, num=96, batch_size=64):
    """Synthetic VQA questions over images of 100 boxes + the global row."""
    from vilbert_tpu.data import synthetic as syn
    from vilbert_tpu.data.tasks import DataLoader, VQADataset
    from vilbert_tpu.data.tokenization import HashTokenizer

    store = syn.synthetic_store(num_images=16, num_boxes=R - 1, feature_dim=cfg.v_feature_size)
    ds = VQADataset(syn.vqa_annotations(num=num, num_labels=3129), store, num_labels=3129,
                    tokenizer=HashTokenizer(cfg.vocab_size),
                    max_seq_length=task.max_seq_length, max_region_num=task.max_region_num)
    return DataLoader(ds, batch_size=batch_size, shuffle=False, drop_last=False)


def random_batch(cfg, batch: int, seed: int) -> dict:
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    t_len = torch.randint(3, T + 1, (batch,), generator=g, device=dev)
    r_len = torch.randint(10, R + 1, (batch,), generator=g, device=dev)
    return dict(
        input_txt=torch.randint(0, cfg.vocab_size, (batch, T), generator=g, device=dev),
        input_imgs=torch.randn(batch, R, cfg.v_feature_size, generator=g, device=dev),
        image_loc=torch.rand(batch, R, cfg.num_locs, generator=g, device=dev),
        token_type_ids=torch.zeros(batch, T, dtype=torch.long, device=dev),
        attention_mask=(torch.arange(T, device=dev)[None] < t_len[:, None]).long(),
        image_attention_mask=(torch.arange(R, device=dev)[None] < r_len[:, None]).long(),
    )


def kernel_calls_per_forward(cfg) -> tuple:
    """(attention, layer_norm) launches of one VL-classifier forward."""
    n_c = cfg.num_connection_layers
    attn = cfg.num_hidden_layers + cfg.v_num_hidden_layers + 2 * n_c
    # two per text/image layer, four per connection layer, the two
    # embedding LNs and the classifier's
    ln = 2 * cfg.num_hidden_layers + 2 * cfg.v_num_hidden_layers + 4 * n_c + 3
    return attn, ln


def phase_slice(checks: Checks) -> tuple:
    import torch

    from vilbert_tpu.core.config import ModelConfig
    from vilbert_tpu_torch.cli.eval_tasks import build_model, run_eval
    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
    from vilbert_tpu_torch.ops.attention import attention
    from vilbert_tpu_torch.ops.layernorm import layer_norm

    cfg = ModelConfig.from_json_file(CONFIG)  # bf16 compute, as the CLI runs it
    task = task1()
    t0 = time.time()
    model = build_model(cfg, seed=SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {CONFIG}: {n_params} params, compute {cfg.compute_dtype}, "
        f"built in {time.time() - t0:.1f} s")

    loader = synthetic_task1_loader(cfg, task)
    n_batches = len(loader)
    with tempfile.TemporaryDirectory() as out_dir:
        attention.launches = layer_norm.launches = 0
        t0 = time.time()
        metrics, records = run_eval(model, cfg, {"TASK1": task}, {"TASK1": loader},
                                    output_dir=out_dir, split=task.val_split)["TASK1"]
        torch.cuda.synchronize()
        launches = {"attention": attention.launches, "layer_norm": layer_norm.launches}
        files = sorted(os.listdir(out_dir))
    log(f"  run_eval TASK1: loss {metrics['loss']:.6f} score {metrics['score']:.6f} "
        f"records {len(records)} samples {metrics['num_samples']} in {time.time() - t0:.1f} s; "
        f"files {files}; launches {launches}")
    want_attn, want_ln = kernel_calls_per_forward(cfg)
    checks.expect(launches["attention"] == n_batches * want_attn,
                  f"attention launches {launches['attention']} == {n_batches} x {want_attn}")
    checks.expect(launches["layer_norm"] == n_batches * want_ln,
                  f"layer_norm launches {launches['layer_norm']} == {n_batches} x {want_ln}")
    checks.expect(math.isfinite(metrics["loss"]) and 0 <= metrics["score"] <= 1,
                  "loss finite, score in [0, 1]")
    checks.expect(len(records) == metrics["num_samples"] == len(loader.dataset)
                  and all(0 <= r["answer"] < 3129 for r in records),
                  "one VQA record per question, answers in the 3129 labels")

    x = random_batch(cfg, CHECK_BATCH, SEED + 1)
    head = ("vil_prediction",)
    model32 = ViLBERTForVLTasks(cfg.replace(compute_dtype="float32"))
    model32.load_state_dict(model.state_dict())
    model32 = model32.to(DEVICE).eval()
    logits = {}
    for name, m in (("fp32", model32), ("bf16", model)):
        with torch.inference_mode():
            logits[name, "kernels"] = m(**x, heads=head).vil_prediction
            logits[name, "plain"] = use_plain_ops(m)(**x, heads=head).vil_prediction
            use_plain_ops(m, False)
    del model32
    ref = logits["fp32", "plain"]
    scale = max(1.0, float(ref.abs().max()))
    # fp32: absolute. bf16: the logits leave the classifier in bf16, whose
    # spacing at |logit| ~ 4 is 2^-5, and 18 layers of bf16 rounding drift a
    # few of those spacings; so 5e-2 per unit of logit scale
    for name, bound in (("fp32", 1e-3), ("bf16", 5e-2 * scale)):
        kern, plain = logits[name, "kernels"], logits[name, "plain"]
        e = float((kern - plain).abs().max())
        checks.expect(
            bool(torch.isfinite(kern).all()) and tuple(kern.shape) == (CHECK_BATCH, 3129)
            and e <= bound,
            f"B={CHECK_BATCH} {name} logits, kernels vs plain ops: max|err| {e:.3e} <= "
            f"{bound:.3e} (max|logit| {scale:.3e}; vs fp32 plain: kernels "
            f"{float((kern - ref).abs().max()):.3e}, plain {float((plain - ref).abs().max()):.3e})",
        )
    checks.end_phase("slice")
    return model, cfg, launches


# -- phase 5 -----------------------------------------------------------------

def phase_timing(model, cfg, card: str) -> dict:
    import torch

    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.ops.attention import attention, attention_ref
    from vilbert_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref

    B = TIME_BATCH
    x = random_batch(cfg, B, SEED + 2)
    for plain in (False, True):
        use_plain_ops(model, plain)
        with torch.inference_mode():
            fwd = lambda: model(**x, heads=("vil_prediction",))
            ms = cuda_time_ms(fwd, iters=10, warmup=2)
        log(f"  forward B={B} T={T} R={R} bf16 {'plain ops' if plain else 'kernels'}: "
            f"{ms:.3f} ms = {B / ms * 1e3:.1f} questions/s [{card}]")
    use_plain_ops(model, False)

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    mask = torch.ones(B, R, dtype=torch.long, device=DEVICE)
    mask[:, 60:] = 0
    times = {}
    for label, heads, d, sq, sk in (("text self", 12, 64, T, T), ("image self", 8, 128, R, R),
                                    ("text->image", 8, 128, T, R),
                                    ("image->text", 8, 128, R, T)):
        q, k, v = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                   for s in (sq, sk, sk))
        bias = ((1.0 - mask[:, :sk].float()) * -10000.0)[:, None, None, :]
        k_ms, p_ms = alternate(lambda: attention(q, k, v, bias, num_heads=heads),
                               lambda: attention_ref(q, k, v, bias, num_heads=heads))
        times[("attention", label)] = (k_ms, p_ms)
        log(f"  attention {label} B={B} h={heads} d={d} {sq}x{sk} bf16: kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
    for label, rows, h, dtype, with_res in (("text", B * T, 768, torch.bfloat16, True),
                                            ("image", B * R, 1024, torch.bfloat16, True),
                                            ("classifier", B, 2048, torch.bfloat16, False),
                                            ("text embedding", B * T, 768, torch.float32, False)):
        xx = torch.randn(rows, h, generator=g, device=DEVICE).to(dtype)
        res = torch.randn(rows, h, generator=g, device=DEVICE).to(dtype) if with_res else None
        w = torch.ones(h, device=DEVICE)
        b = torch.zeros(h, device=DEVICE)
        k_ms, p_ms = alternate(lambda: layer_norm(xx, w, b, residual=res),
                               lambda: layer_norm_ref(xx, w, b, residual=res))
        times[("layer_norm", label)] = (k_ms, p_ms)
        log(f"  layer_norm {label} rows={rows} H={h} residual={with_res} {str(dtype)[6:]}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails outside a checkout: the port is not next to this script
    from vilbert_tpu_torch.ops import _build

    card = card_line()
    log(f"[1 device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _build.load_library()
    log(f"[2 build] {_build.library_path().name} in {time.time() - t0:.1f} s")

    checks = Checks()
    log("[3 kernels vs plain]")
    err = phase_kernels(checks)
    log("[4 slice]")
    model, cfg, launches = phase_slice(checks)
    log("[5 timing]")
    times = phase_timing(model, cfg, card)

    kernels = [
        {"name": "attention_fwd", "route": "cuda", "source": "vilbert_tpu_torch/csrc/attention.cu",
         "replaces": "vilbert_tpu/ops/pallas_attention_train.py:69",
         "launches": launches["attention"], "max_abs_err": err["attention"],
         "ms": times[("attention", "image self")][0],
         "plain_ms": times[("attention", "image self")][1]},
        {"name": "layer_norm_fwd", "route": "cuda", "source": "vilbert_tpu_torch/csrc/layernorm.cu",
         "replaces": "vilbert_tpu/ops/pallas_layernorm.py:28",
         "launches": launches["layer_norm"], "max_abs_err": err["layer_norm"],
         "ms": times[("layer_norm", "image")][0],
         "plain_ms": times[("layer_norm", "image")][1]},
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
