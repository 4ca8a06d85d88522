#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (vilbert_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from vilbert_tpu_torch/csrc and drives the
port's paths at the full width of configs/bert_base_6layer_6conect.json,
weights drawn from a seed: VQA evaluation (TASK1 of configs/tasks.yml),
the Conceptual Captions pretraining step, the 12-in-1 multi-task trainer
on the flagship recipe (tasks 1-2-4-7-8-9-10-11-12-13-15-17, task
tokens), image-text retrieval and the demo, and the training options
(bf16 gradients and moments, RAdam, checkpoints and resume); then the
single-stream baseline at the full width of configs/bert_base_baseline.json
(VQA eval, the CC step, the flagship tasks it has heads for, retrieval),
the CC step with NCE, and K1 and K2 to 1,024 keys; then the model
options: int8 inference (``--int8``, static calibration), the attention
maps (``visualization``, K1 writing its probabilities) and ``--remat``;
then the last modules: batches staged ahead of the step at depths 0 and 2,
data parallelism (NCCL at world size 1; two ranks over gloo on the card),
the native VFR reader and the TF checkpoint import; then the model axis
(a 2 x 2 mesh of four processes, the update sharded) and in_batch_pairs
across two data ranks.

1. device: the card's name and power limit; TF32 off for fp32 comparisons;
2. build: nvcc for sm_90a, one process per source, timed;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at the paths' shapes, the edges of its range and the tiling edges
   of the tensor-core variants (Sq or Sk of 1, 16, 17, 65, 128), with each
   call's variant checked on its counter (K1: bf16 at Sk <= 128 on "tc",
   bf16 at Sk > 128 on "long_tc", fp32 on "cc"), a stride-0 batch and a
   misaligned operand (refused); the long K1's tiling edges (Sq of 1, 16,
   17, 65, 128, 129, 200, 257, 306, 512 against Sk of 129, 192, 200, 257,
   306, 512: partial key tiles of 64 and partial query blocks, a fully
   padded row) at rates 0 and 0.1 and a stride-0 batch k, v at Sk = 200;
   K2's long-sequence variants (Sq or Sk above 128: bf16 on the tensor
   cores, fp32 on the CUDA cores) at their tiling edges 129, 200, 257, 306
   and 512; each K4 variant ("block", "persistent", named) and the routed
   call at H of 128, 384, 768, 1024 and 2048 and rows of 1, 2, 31, 132, 811
   and each crossover of ``ln_variant`` +- 1, with and without a residual,
   each call on its variant's counter, with fp32 and with bf16 weight and
   bias (the bf16-weight instantiation, on its own counter too), and a
   misaligned operand (refused); the wgmma K2 (``wg``, bf16 past 128
   keys) at Sq x Sk edges of its 64-row tiles and narrowed tails (1, 15,
   16, 17, 63, 64, 65, 127, 128, 129, 131, 200, 257, 306, 562, 1023, 1024,
   each against itself and the list reversed; d 64 and 128; rates 0 and
   0.1), from K1's output and row log-sum-exps (``return_lse``, each LSE
   against torch.logsumexp within 1e-4 + 1e-6 |ref|), every launch on its
   counter and bit-identical twice, with a stride-0 batch cotangent and
   bias and a misaligned operand refused; the mma.sync K2 it took over
   (``long_tc``, named) at the long edges; the rational gelu's forward and
   backward kernels bit-equal to the plain chain on the card over every
   bf16 pattern, 2^20 fp32 values and each cell's FFN activation, each
   call on its counter, a misaligned, strided or fp16 operand refused, and
   each shape timed against the plain chain and its byte bound
   (``phase_gelu_kernels``); the hidden-state dropout's forward and
   backward kernels bit-equal to the plain int64 chain on the card over
   every bf16 pattern (rates 0.1 and 0.5, across the flat index's wrap at
   2^32), fp32 edges and each training cell's site shape, no int64 or
   boolean tensor made, each call on its counter, a misaligned, strided or
   fp16 operand refused, and each shape timed against the chain and its
   byte bound (``phase_dropout_kernels``).
   Forward (K1 at rate 0 and 0.1, K4): fp32 1e-4 absolute (1e-3 on a row
   whose keys are all padded), bf16 2^-7 * max|ref| plus one bf16 ulp.
   Backward (K2 at rate 0 and 0.1): fp32 1e-4 * max|ref| (and on a batch
   element whose keys are all padded, 2^-9 of its own max|ref| on top: its
   scores sit at -10000, where a summation order flips one by a whole fp32
   step, ``_bwd_errors``), bf16 as the forward. The K3 entry (``fused_attention``, served by K1 and K2 at rate
   0) likewise;
4. VQA slice: ``run_eval`` (the eval CLI's function) on synthetic TASK1 at
   T=23, R=101, with the launch counters reset just before and read just
   after: every K1 launch on the tensor-core variant, K4's launches by
   shape (recorded) and by variant as ``ln_forward`` says; then a batch of 256
   through the kernels and through the plain ops, fp32 logits within 1e-3
   and bf16 logits finite and within 5e-2;
5. VQA timing: K4's shapes in one forward at B=1024 (recorded) against
   ``ln_shapes``; eval questions/s of the forward at B=1024 in bf16
   (kernels and plain ops); at the four attention shapes, and at every
   distinct K4 shape of the three paths (``ln_shapes``: 37 (rows, H, dtype,
   residual), with each path's launches), each kernel against its plain
   version (K4's output also checked) and a PyTorch library call computing
   the same function (``scaled_dot_product_attention``;
   ``F.layer_norm(x + residual)``, the add inside the timed call) with the
   kernel's bound; the CUDA-core K1 and the long tensor-core K1 beside the
   tensor-core one at image self-attention (the long one also checked
   against the plain version), both K4 variants beside the routed one;
6. training slice: ``train`` (the train CLI's function) on the synthetic CC
   loader at B=256, T=36, R=37, bf16, dropout 0.1 at every site, for a few
   steps, with the counters reset just before and read just after: finite
   losses, and K1, K2 and K4 launched as often as the config says, K1 and
   K2 on the tensor-core variants, K4 by shape and variant as ``ln_shapes``
   says; then one fp32 step at B=32 with dropout
   on through the kernels and through the plain ops, from the same weights
   with the same masks;
7. training timing: samples/s of the bf16 step at B=256 (kernels and plain
   ops, one batch held on the card, constant schedule); K1 and K2 at rates
   0 and 0.1 against their plain versions at the CC shapes and B=256, each
   output also checked against its plain twin's with phase 3's bounds, with
   SDPA (forward; forward and backward less forward) at rate 0 and the
   bounds; the CUDA-core K1 and K2 beside the tensor-core ones at image
   self-attention; the tiling edges again at B=256;
8. multi-task slice: ``train`` (the multi-task CLI's function) on the
   flagship recipe's twelve tasks, each at its batch size, text length
   (+1 task token) and region count, synthetic batches in its process
   mode's layout, bf16, dropout 0.1 at every site, the ``mannul`` schedule,
   for two round-robin iterations, then ``evaluate`` of one batch per task;
   counters reset just before and read just after: K1 30 a forward
   ("tc" at Sk <= 128, "long_tc" above, none on "cc"), K2 30 a step (28 for
   the V-logit tasks, whose loss reads the image stream only; "wg" past 128
   keys and for text->image, "tc" else), K4 as the config
   says, by shape (recorded) and variant as ``ln_shapes`` says;
   every loss finite; after each task's step every other head (``cls``
   included) bitwise unchanged and its own moved. Then one fp32 iteration
   with dropout at 2 samples a task, full geometry, through the kernels and
   through the plain ops in lockstep, each task's step from the same
   weights with the same masks: losses within 1e-5 and every gradient
   within phase 6's bounds (an Adam update amplifies gradients' rounding
   where they are near eps, so the parameters after a step are not held
   to these bounds); every fp32 K1 launch of that iteration on "cc";
9. multi-task timing: each task's step (device-synced, one batch held on
   the card), one iteration through the host loader, peak memory; K1 and
   K2 at the Visual7w and GuessWhatPointing attention shapes against their
   plain versions (outputs within phase 3's bounds, at rates 0 and 0.1,
   each call on its variant's counter), SDPA and their bounds; the
   CUDA-core K1 (checked too), and K2's ``long_tc`` and ``long`` (CUDA
   cores) beside the routed ``wg``, which is timed from the forward's
   output and row log-sum-exps as the backward of ``attention`` gets them;
10. retrieval and demo: ``cli/eval_retrieval.py``'s ``run`` over a
   synthetic pool of 1,000 images x 101 regions x 2048 in chunks of 500,
   captions of 30 tokens: 10 captions fine-tuned with ``--fast_mode`` and 2
   zero-shot, counters reset just before each and read just after (K1 30 a
   forward, all on "tc"; K4 by shape with the text stream at batch 1 before
   the first co-attention); the bf16 scores against the plain ops within
   5e-2 per unit of logit scale; fp32 scores with ``fast_mode`` against the
   caption broadcast on the host within 1e-4; captions/s; ``cli/demo.py``
   once at the flagship config (launches and shapes likewise); K1 and K4
   timed at the retrieval and demo shapes;
11. training options: ``train_concap.train`` with ``--bf16_grads
   --bf16_adam_state`` for 2 steps (finite losses, bf16 moments, every K4
   launch on the bf16-weight instantiation, K4's shapes with the text
   embedding's in bf16), then a bf16-gradient step at fp32 compute
   through the kernels and the plain ops (loss within 1e-5, each gradient
   within one bf16 rounding of its max plus 1e-6 of the largest); the
   bf16-weight K4 timed at the CC and multi-task shapes; one flagship
   iteration with ``--optim radam`` (finite losses, launches); the CC run
   resumed: 2 steps, a checkpoint, 2 resumed steps against 4 uninterrupted
   (fp32, dropout off, one held batch; bitwise, or within 1e-6 of each
   tensor's max); the flagship trainer of phases 8-9 saved and restored
   into a new one (parameters, moments and host state equal), the
   checkpoint's size and its save and restore seconds;
12. K1 and K2 past 512 keys: the long variants (K1 "long_tc" bf16 and "cc"
   fp32, K2 "wg" bf16, "long_tc" by name beside it, and "long" fp32) at
   Sq x Sk edges of 511, 512, 513, 562 and 1024 (LONG_1024_CASES), h12 d64
   and h8 d128, rates 0 and 0.1, against the plain versions within phase
   3's bounds, each call on its variant's counter; a length past
   KERNEL_MAX_KEYS refused; K2 timed at 1024 x 1024 (``LONG_TIMED``);
13. the single-stream baseline (``--baseline``, configs/bert_base_baseline
   .json: 12 layers of 768) through ``run_eval`` on synthetic TASK1 at
   B=1024, T=23, R=101 (124 keys, K1 on "tc"; K1 and K4 launches, K4 by
   shape), fp32 logits against the plain ops within 1e-3 and bf16 within
   phase 4's bound, questions/s;
14. the baseline's CC step through ``train_concap.train --baseline``
   (``run_pretraining``, ``model_family="basebert"``) at B=256, T=36, R=37
   (73 keys), ``lm_gather`` 12, dropout 0.1: 12 K1 a step on "tc" and 12
   K2 on "wg", K4 by shape; an fp32 step with dropout, kernels against
   plain ops within phase 6's bounds; samples/s;
15. the two-stream CC step with ``--visual_target 2`` (NCE, 128 negatives)
   at the same geometry: finite losses, two runs from one seed equal,
   samples/s and peak memory of the step;
16. one iteration of ``cli/train_tasks.py::train --baseline`` over the
   flagship tasks the baseline has heads for (all but NLVR2, Visual
   Entailment and GQA), no task token: K1 and K2 launches by variant
   (GuessWhatPointing's 256 + 306 = 562 keys on K1's "long_tc" and K2's
   "wg"), K4's by shape,
   each task's step time;
17. baseline retrieval through ``cli/eval_retrieval.py``'s ``run``
   (``--baseline``), phase 10's pool of 1,000 images in chunks of 500 with
   4 captions fine-tuned and 2 zero-shot (131 keys, K1 on "long_tc";
   launches and K4 shapes), bf16 scores against the plain ops, captions/s;
18. K1 and K2 at the baseline's shapes (124 x 124 at B=1024, 73 x 73 at
   B=256 with and without dropout, 131 keys at B=500, and every (batch,
   T + R) of phase 16's tasks, 121 to 562 keys, at rates 0 and 0.1 with
   the backward; K2's routed variant beside the bf16 one it was chosen
   over) and K4 at the row counts of phases 13, 14 and 16, against the
   plain versions, SDPA (``F.layer_norm(x + residual)``) and the bounds;
19. int8 inference: ``run_eval`` on synthetic TASK1 with ``--int8`` (counts
   reset just before and read just after: ``torch._int_mm`` once an int8
   site a forward, some on zero-padded operands; K1 and K4 as phase 4
   says), B=256 bf16 logits finite and correlated with the bf16 forward's
   (> 0.98, ``tests/test_quant.py``'s bound), static int8 calibrated on 64
   samples (``bench.py:66-78``) likewise; ``int8_dense``, dynamic and
   static, at every int8 site shape of the VQA forward
   (B=1024) and of the demo (B=1) against the plain versions (int32
   products bit-equal, outputs within fp32 rounding); each VQA site shape's
   quantization passes, ``int_mm`` padded and ``torch._int_mm`` on
   operands padded beforehand, and bf16 ``F.linear``; questions/s of the
   bf16, dynamic and static forwards at B=1024 with the quantization
   passes' share; ``cli/demo.py --int8``;
20. visualization: a VQA forward at B=256 with maps (counts reset just
   before and read just after: every K1 launch with its probabilities, on
   "tc"), each site's maps against ``attention_ref`` on the inputs that
   site got, element by element within one rounding (``_probs_error``),
   its context within phase 3's bounds, the logits bit-equal to the forward
   without maps; K1 with probabilities on every variant ("long_tc" past 128
   keys, "cc" in fp32) at rates 0 and 0.1, held likewise; the forward's time with maps
   and without; K1 with probabilities timed at the VQA and demo shapes;
21. remat: ``train_concap.train --remat`` for 2 steps at B=256, T=36, R=37,
   dropout 0.1 (counts reset just before and read just after: K1 twice a
   step, the recompute included, K2 once, K4 again for each encoder
   LayerNorm); one bf16 step with remat and without from the same weights
   and seed, loss and every gradient within phase 6's bounds and the
   dropout generator in one state; samples/s and peak memory of both;
22. prefetch (``data.prefetch.device_prefetch``): the CC driver
   (``run_pretraining`` over the synthetic ``ConceptCapLoader``, B=256,
   bf16, dropout 0.1) for 9 steps at depths 0 and 2, counters reset before
   each run and read after it: the metrics bit-equal across depths,
   samples/s over 5 untraced steps, the device time of the 2 steps after
   them (``torch.profiler``) and the idle share; the loader's time for a
   batch alone; phase 8's flagship trainer built again at depth 0 (phase 8
   stages 2): its two iterations' task losses bit-equal to phase 8's, one
   iteration timed and one profiled, against phase 9's iterations at
   depth 2;
23. data parallelism: (a) ``train_concap.train`` and
   ``train_tasks.train`` with ``--coordinator`` over NCCL at world size 1,
   every loss bit-equal to the runs without a process group (phase 8's for
   the trainer); (b) two ranks in two processes (``--dp_worker``) over
   gloo on CUDA tensors, 3 CC steps at B_local=128 a leg against one
   process on B=256 run meanwhile: fp32 metrics within 1e-5 and the first
   step's gradients within phase 6's bounds, the fp32 parameters' distance
   read as phase 26's (elements beyond 1e-5 of their tensor's max counted,
   no model axis); fp32 compute with bf16
   gradients all-reduced in bf16, the first step's gradients within phase
   11's bf16-gradient bound; bf16 compute; bf16 losses within
   ``bf16_bound``; the ranks' parameters bit-equal (sha256);
24. the native VFR reader built into build/native_vfs and read against
   ``VrfFeatureStore`` (64 images x 101 regions), time per image;
25. the TF import of synthetic variables for every text-stream parameter
   of the full-width model against a plain name mapping;
   ``load_tf_checkpoint`` reported skipped without tensorflow;
26. the model axis (``--rank_worker``s started by it, gloo on CUDA
   tensors, one process on the global batch run meanwhile): (a) a 2 x 2
   (data, model) mesh of four processes, 2 full-width CC steps at B=64
   with dropout 0.1, the update sharded by ``param_sharding_rules``: fp32
   losses within 1e-5, the first step's gradients within phase 6's bound,
   the parameters within 1e-5 of each tensor's max plus 5% of lr x steps
   (elements beyond 1e-5 counted), and a control past that bound (rank
   0's slice of any one sharded parameter left as it was before the last
   step), rank 0's sharded update bit-equal to a replicated optimizer's on
   the same gradients;
   bf16 losses within ``bf16_bound`` and K1, K2, K4 launched as the config
   says; each rank's moments its share of the elements (bytes printed
   beside the replicated state's), the ranks' parameters bit-equal
   (sha256); (b) ``in_batch_pairs`` over two data ranks, the fp32 encoder
   forward and backward at 8 texts and images a rank (256 pairs): each
   rank's 128 rows within 1e-4 of one process's, the averaged gradients
   within 1e-4 of each max.

Times: a kernel's ``ms`` (and its plain version's, the library call's,
another variant's) is device time, calls run back to back behind a
spin kernel that lets the host enqueue them all first (``device_ms``);
``wall_ms`` is CUDA-event time per call with the host's launch gaps, which
at the CC shapes reads the host's enqueue rate more than the kernel.
Bounds: the larger of the bytes a call must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the
card's peak for their type (989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s fp32 on the CUDA cores): every kernel here is bound by bytes.

The last three lines are the card line, a JSON object of the kernels and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
them. Without a CUDA device, or outside a checkout, it exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import itertools
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
TRAIN_BATCH, TRAIN_T, TRAIN_R = 256, 36, 37  # the CC step of bench.py:30-32
TRAIN_STEPS = 3
TRAIN_CHECK_BATCH = 32  # fp32 step, kernels vs plain ops
LM_GATHER = TRAIN_T // 3
DROPOUT_SEED = 3_000_000_001  # >= 2^31: the uint32 seed path


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


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, measured once."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fns: dict, iters: int = 20) -> dict:
    """name -> ms per call of ``fns[name]`` run back to back on the card: a
    spin kernel holds the stream while the host enqueues all ``iters``
    calls, and CUDA events time them from after the spin. Unlike
    ``cuda_time_ms`` it leaves out the host's gaps between launches, so it
    reads a small kernel's own time where the host enqueues more slowly
    than the card runs."""
    import torch

    out = {}
    for name, fn in fns.items():
        wall = cuda_time_ms(fn, iters)  # also the warm-up; the host needs at most this
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * iters * wall * _sleep_cycles_per_ms()) + 10_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / iters
    return out


def alternate(kernel_fn, plain_fn, iters: int = 50) -> tuple:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_time_ms(plain_fn, iters)
    k1 = cuda_time_ms(kernel_fn, iters)
    k2 = cuda_time_ms(kernel_fn, iters)
    p2 = cuda_time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``nbytes`` and does ``flops`` at ``peak`` FLOP/s."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_cost(B, heads, d, sq, sk, elt=2) -> dict:
    """Bytes and flops of K1 (q, k, v, the fp32 [B, Sk] bias in; out) and K2
    (q, k, v, g, bias in; dq, dk, dv out; S, dP, dv, dq, dk products)."""
    H = heads * d
    q, kv, bias = elt * B * sq * H, elt * B * sk * H, 4 * B * sk
    mnk = B * heads * sq * sk * d
    return {"fwd": (2 * q + 2 * kv + bias, 4 * mnk), "bwd": (3 * q + 4 * kv + bias, 10 * mnk)}


def counted(wrapper, variant, fn):
    """fn() and whether it added one launch to ``wrapper``'s total and to
    ``variant``'s count."""
    before = (wrapper.launches, getattr(wrapper, f"launches_{variant}"))
    out = fn()
    after = (wrapper.launches, getattr(wrapper, f"launches_{variant}"))
    return out, after == (before[0] + 1, before[1] + 1)


def sdpa_views(B, heads, d, *tensors):
    """[B, S, H] tensors as the [B, h, S, d] views SDPA takes."""
    return [t.view(B, t.shape[1], heads, d).transpose(1, 2) for t in tensors]


def library_attention_fns(q, k, v, bias, cot, heads, d) -> dict:
    """SDPA at rate 0 on the same q, k, v ([B, h, S, d] views) with the bias
    as a bf16 additive mask: ``library`` runs the forward,
    ``library_fwd_bwd`` the forward and ``torch.autograd.grad``. Timed here
    only: the port never calls SDPA."""
    import torch
    import torch.nn.functional as F

    B = q.shape[0]
    mask = bias.to(q.dtype)
    qh, kh, vh = sdpa_views(B, heads, d, q, k, v)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    gh, = sdpa_views(B, heads, d, cot)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*sdpa_views(B, heads, d, *leaves), attn_mask=mask)
        return torch.autograd.grad(out, leaves, gh)

    return {"library": fwd, "library_fwd_bwd": fwd_bwd}


#: other kernel variants a timed row may carry beside the routed one, as
#: ``<variant>_ms``: K1's, K2's and K4's named
OTHER_VARIANTS = ("cc", "long_tc", "tc", "wg", "block", "persistent")


def bwd_fns(q, k, v, b, cot, kw: dict) -> dict:
    """K2 at one shape for ``timed_row``: the routed variant ("kernel"; where
    it is "wg", from the forward's output and row log-sum-exps, as the
    backward of ``attention`` gets them), the plain version, and the bf16
    variant it was chosen over, named: "wg" beside "tc" or "long_tc", and
    "long_tc" ("tc" at Sq, Sk <= 128) beside "wg"."""
    from vilbert_tpu_torch.ops.attention import (
        TC_MAX_SEQ,
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_kernel,
        bwd_variant,
        fwd_variant,
    )

    sq, sk, d = q.shape[1], k.shape[1], q.shape[2] // kw["num_heads"]
    out, lse = attention_kernel(q, k, v, b, variant=fwd_variant(q.dtype, sq, sk, d),
                                return_lse=True, **kw)
    fns = {"kernel": lambda: attention_bwd(q, k, v, b, cot, out=out, lse=lse, **kw),
           "plain": lambda: attention_bwd_ref(q, k, v, b, cot, **kw)}
    if bwd_variant(q.dtype, sq, sk, d) == "wg":
        other = "long_tc" if max(sq, sk) > TC_MAX_SEQ else "tc"
        fns[other] = lambda: attention_bwd_kernel(q, k, v, b, cot, variant=other, **kw)
    else:
        fns["wg"] = lambda: attention_bwd_kernel(q, k, v, b, cot, variant="wg", out=out, lse=lse,
                                                 **kw)
    return fns


def k1_fns(q, k, v, b, kw: dict) -> tuple:
    """(fns, routed): K1 at one shape for ``timed_row``, the routed variant
    ("kernel") and the plain version, and every other bf16 variant by name
    beside it (``tc`` at Sk <= 128, ``long_tc``, ``wg``): the variants the
    routed one was chosen over, or that were chosen over it."""
    from vilbert_tpu_torch.ops.attention import (
        TC_MAX_SEQ,
        attention,
        attention_kernel,
        attention_ref,
        fwd_variant,
    )

    sq, sk, d = q.shape[1], k.shape[1], q.shape[2] // kw["num_heads"]
    routed = fwd_variant(q.dtype, sq, sk, d)
    fns = {"kernel": lambda: attention(q, k, v, b, **kw),
           "plain": lambda: attention_ref(q, k, v, b, **kw)}
    for variant in ("tc", "long_tc", "wg"):
        if variant != routed and not (variant == "tc" and sk > TC_MAX_SEQ):
            fns[variant] = functools.partial(attention_kernel, q, k, v, b, variant=variant, **kw)
    return fns, routed


def vl_attention_shapes(cfg, t: int, r: int) -> list:
    """(Sq, Sk, head width) of each attention of one two-stream forward over
    t tokens and r regions: text self a text layer, image self an image
    layer, text->image and image->text a connection layer."""
    d_t = cfg.hidden_size // cfg.num_attention_heads
    d_v = cfg.v_hidden_size // cfg.v_num_attention_heads
    d_c = cfg.bi_hidden_size // cfg.bi_num_attention_heads
    return ([(t, t, d_t)] * cfg.num_hidden_layers + [(r, r, d_v)] * cfg.v_num_hidden_layers
            + [(t, r, d_c), (r, t, d_c)] * cfg.num_connection_layers)


def k1_routed(shapes, times: int = 1) -> dict:
    """K1's launch counts ("attention" and "attention_<variant>") of
    ``times`` bf16 calls at each (Sq, Sk, head width) of ``shapes``, as
    ``fwd_variant`` routes them."""
    import torch

    from vilbert_tpu_torch.ops.attention import VARIANTS, fwd_variant

    out = {"attention": times * len(shapes), **{f"attention_{v}": 0 for v in VARIANTS}}
    for sq, sk, d in shapes:
        out[f"attention_{fwd_variant(torch.bfloat16, sq, sk, d)}"] += times
    return out


def k1_text(launches: dict, want: dict) -> str:
    return ", ".join(f"{name.removeprefix('attention_')} {launches[name]} == {n}"
                     for name, n in want.items())


def check_k1(checks: Checks, what: str, launches: dict, want: dict, *, no_k2: bool = True):
    """K1's launches, in all and by variant, equal ``want`` (``k1_routed``);
    with ``no_k2``, no K2 launch."""
    ok = all(launches[name] == n for name, n in want.items())
    checks.expect(ok and (not no_k2 or launches["attention_bwd"] == 0),
                  f"{what}: K1 launches {k1_text(launches, want)}"
                  + (f", K2 {launches['attention_bwd']} == 0" if no_k2 else ""))


def check_k1_variants(checks: Checks, err: dict, fns: dict, what: str) -> None:
    """Each K1 variant of ``fns`` (``k1_fns``: the routed "kernel" and the
    others by name) against the plain version within phase 3's bf16 bound,
    before they are timed."""
    import torch

    with torch.inference_mode():
        want = fns["plain"]()
        for name in ("kernel", *OTHER_VARIANTS):
            if name in fns:
                e, bnd, ok = _fwd_error(fns[name](), want, "bfloat16")
                track_error(err, "attention_fwd", name, e)
                checks.expect(ok, f"{what} [{name}]: max|err| {e:.3e} <= {bnd:.3e}")


def timed_row(fns: dict, kernel: str, plain: str, nbytes: float, flops: float, peak: float,
              *, library=None, iters: int = 20) -> dict:
    """One kernel at one shape: device times (``device_ms``, ``iters``
    calls) of the kernel, its plain version, the library call and the other
    variants (entries of ``fns`` named in OTHER_VARIANTS) where given; wall
    times of kernel and plain by CUDA events, alternated; the bound.
    ``library`` names an entry of ``fns`` or is a callable of the device
    times (a difference of two of them)."""
    dev = device_ms(fns, iters)
    wall = alternate(fns[kernel], fns[plain], iters * 5 // 2)
    b_ms, b_by = bound(nbytes, flops, peak)
    row = dict(ms=dev[kernel], plain_ms=dev[plain], wall_ms=wall[0], plain_wall_ms=wall[1],
               bound_ms=b_ms, bound_by=b_by,
               library_ms=None if library is None else
               library(dev) if callable(library) else dev[library])
    for variant in OTHER_VARIANTS:
        if variant in fns:
            row[f"{variant}_ms"] = dev[variant]
    return row


def row_text(row: dict) -> str:
    lib = f", library {row['library_ms']:.4f}" if row["library_ms"] is not None else ""
    others = "".join(f"; variant {v} {row[v + '_ms']:.4f} ({row[v + '_ms'] / row['ms']:.2f}x)"
                     for v in OTHER_VARIANTS if v + "_ms" in row)
    return (f"device ms: kernel {row['ms']:.4f}, plain {row['plain_ms']:.4f}{lib}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}; {row['bound_ms'] / row['ms']:.1%} of it)"
            f"{others}; wall ms: kernel {row['wall_ms']:.4f}, plain {row['plain_wall_ms']:.4f}")


# -- phase 3 -----------------------------------------------------------------

#: (heads, head_dim, Sq, Sk) where the tensor-core kernels' m16 and k16
#: tiles are ragged or full, and Sq = Sk = 128, their end of the range
TILE_EDGE_CASES = [
    (8, 128, 17, 65), (8, 128, 65, 17), (12, 64, 1, 128), (8, 128, 128, 128), (12, 64, 16, 16),
]
#: the slice's four kinds of attention (also at T=24, with
#: --task_specific_tokens), Sk=1, 128 < Sk <= 512 (the long tensor-core
#: variant in bf16) and the tiling edges
ATTENTION_CASES = [
    (12, 64, 23, 23), (12, 64, 24, 24), (8, 128, 101, 101), (8, 128, 23, 101),
    (8, 128, 101, 23), (8, 128, 24, 101), (8, 128, 101, 24), (8, 128, 23, 1),
    (8, 128, 101, 512), (12, 64, 23, 512), (8, 128, 23, 129), *TILE_EDGE_CASES,
]
#: the long-sequence K2's tiling edges (tiles of 64): one past 128, 200,
#: 257, 306 (GuessWhatPointing), 512, in both directions
LONG_EDGE_CASES = [
    (8, 128, 129, 129), (8, 128, 200, 21), (8, 128, 21, 200), (12, 64, 257, 257),
    (8, 128, 306, 306), (8, 128, 257, 306), (8, 128, 306, 257), (12, 64, 512, 512),
    (8, 128, 1, 512), (12, 64, 512, 1),
]
#: the long K1's tiling edges (key tiles of 64, blocks of at most 128 query
#: rows evened out): every Sq of 1, 16, 17, 65, 128, 129, 200, 257, 306,
#: 512 and every Sk of 129, 192, 200, 257, 306, 512, at both head widths
LONG_FWD_EDGE_CASES = [
    (8, 128, 1, 129), (12, 64, 16, 192), (8, 128, 17, 200), (12, 64, 65, 257),
    (8, 128, 128, 306), (8, 128, 129, 512), (12, 64, 200, 129), (8, 128, 257, 192),
    (8, 128, 306, 200), (12, 64, 512, 306), (8, 128, 512, 512),
]
#: the CC step's four attentions (text self, image self, text->image,
#: image->text), Sk=1, Sq=Sk=128 at d=64, the tiling edges and the long K2's
CC_ATTENTION_CASES = [
    (12, 64, 36, 36), (8, 128, 37, 37), (8, 128, 36, 37), (8, 128, 37, 36),
    (8, 128, 36, 1), (12, 64, 128, 128), *TILE_EDGE_CASES, *LONG_EDGE_CASES,
]
#: the card's peaks (H100 SXM data sheet, dense): device memory, bf16 on the
#: tensor cores, fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
FP32_FLOPS = 67e12
#: (label, heads, head_dim, Sq, Sk) of the VQA forward's and the CC step's
#: attentions
VQA_ATTENTIONS = (("text self", 12, 64, T, T), ("image self", 8, 128, R, R),
                  ("text->image", 8, 128, T, R), ("image->text", 8, 128, R, T))
CC_ATTENTIONS = (("text self", 12, 64, TRAIN_T, TRAIN_T),
                 ("image self", 8, 128, TRAIN_R, TRAIN_R),
                 ("text->image", 8, 128, TRAIN_T, TRAIN_R),
                 ("image->text", 8, 128, TRAIN_R, TRAIN_T))
#: K4's widths at phase 3: a warp's 32 vectors of 4 (128), 8-byte bf16
#: vectors (384), and the paths' 768, 1024 and 2048
LN_EDGE_WIDTHS = (128, 384, 768, 1024, 2048)
LN_ROWS = 8 * 101 + 3  # not a multiple of any block


def _attention_operands(g, B, heads, d, sq, sk, dtype):
    """q, k, v, the cotangent g and an additive bias with padded keys and a
    fully padded last row."""
    import torch

    from vilbert_tpu_torch.ops.attention import make_additive_mask

    lengths = torch.randint(1, sk + 1, (B,), generator=g, device=DEVICE)
    lengths[0] = sk
    mask = (torch.arange(sk, device=DEVICE)[None] < lengths[:, None]).int()
    mask[B - 1] = 0
    q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).to(dtype)
                    for s in (sq, sk, sk, sq))
    return q, k, v, cot, make_additive_mask(mask)


def _fwd_error(got, want, dtype) -> tuple:
    """(max|err|, bound, ok): fp32 1e-4 on rows with a valid key and 1e-3 on
    the fully padded last row, whose scores sit at -10000 where fp32 spacing
    is 2^-10 (the kernel's fused multiply-add rounds them once, the plain
    path twice); bf16 one rounding of the largest output."""
    diff = (got.float() - want.float()).abs()
    e = float(diff.max())
    if dtype != "float32":
        bound = bf16_bound(want.float())
        return e, bound, e <= bound
    return e, 1e-4, float(diff[:-1].max()) <= 1e-4 and float(diff[-1].max()) <= 1e-3


def _probs_error(got, want, dtype, bias) -> tuple:
    """(max|err|, worst err / bound, ok) of attention probabilities
    [B, h, Sq, Sk] against the plain version's, element by element. Both
    compute P in fp32 and round it to the output dtype once; the fp32 values
    differ by far less than a bf16 step, so two bf16 roundings land at most
    one step apart, and one step is at most 2^-7 of the element: bf16 is
    held to 2^-7 |ref| + 2^-8 / Sk (the floor for entries near 0), fp32 to
    2^-16 |ref| + 2^-16 / Sk. A batch element whose keys are all padded
    (``bias`` [B, 1, 1, Sk] or [B, Sk] at -10000) gets 2^-8 |ref| more:
    its scores sit at -10000, where fp32 spacing is 2^-10, and q.k rounded
    once (the kernel's fused multiply-add) or twice (the plain version)
    moves each P by up to that step relative, the normaliser likewise. A
    wrong normaliser or a P from the wrong key is off by its own size."""
    ref = want.float()
    diff = (got.float() - ref).abs()
    sk = ref.shape[-1]
    rel, floor = (2.0 ** -16, 2.0 ** -16 / sk) if dtype == "float32" else (2.0 ** -7,
                                                                            2.0 ** -8 / sk)
    bound = rel * ref.abs() + floor
    if bias is not None:
        padded = (bias.float().reshape(bias.shape[0], -1) <= -10000.0).all(-1)
        bound = bound + 2.0 ** -8 * ref.abs() * padded.float()[:, None, None, None]
    ratio = float((diff / bound).max())
    return float(diff.max()), ratio, ratio <= 1.0


def _bwd_errors(got, want, dtype, bias=None) -> tuple:
    """(max|err| over dq, dk, dv, ok): fp32 within 1e-4 * max|ref|, bf16
    within one bf16 rounding of max|ref|, each gradient on its own.

    With ``bias``, an fp32 batch element whose keys are all padded is held
    to 2^-9 of its own max|ref| on top: its scores sit at -10000, where fp32
    spacing is 2^-10, and q.k summed in another order than the plain
    version's moves a score across a rounding boundary about once in 10^4
    scores; that score then differs by a whole 2^-10, its P by 2^-10
    relative, and each gradient term it feeds likewise (two such terms'
    worth). At Sq=1, Sk=128 such an element crosses the 1e-4 * max|ref|
    bound on some draws; scripts/probe_k2_padded.py measures both bounds
    over many."""
    padded = None
    if bias is not None and dtype == "float32":
        padded = (bias.reshape(bias.shape[0], -1) <= -10000.0).all(-1)
    worst, ok = 0.0, True
    for a, b in zip(got, want):
        diff = (a.float() - b.float()).abs()
        worst = max(worst, float(diff.max()))
        if dtype != "float32":
            ok = ok and float(diff.max()) <= bf16_bound(b.float())
            continue
        bound = 1e-4 * float(b.float().abs().max())
        if padded is None or not bool(padded.any()):
            ok = ok and float(diff.max()) <= bound
            continue
        pad_bound = 2.0 ** -9 * float(b[padded].float().abs().max()) + bound
        valid_ok = bool(padded.all()) or float(diff[~padded].max()) <= bound
        ok = ok and valid_ok and float(diff[padded].max()) <= pad_bound
    return worst, ok


def track_error(err: dict, kernel: str, variant: str, e: float) -> None:
    """Keep the largest error of a kernel, and of K1's long tensor-core and
    CUDA-core variants and K2's long tensor-core and wgmma variants on their
    own."""
    err[kernel] = max(err[kernel], e)
    own = f"{kernel}_{variant}"
    if own in err:
        err[own] = max(err[own], e)


def phase_training_kernels(checks: Checks, g, err: dict) -> None:
    """K1 at rate 0.1 and K2 at rates 0 and 0.1 against their plain twins,
    and the K3 entry at rate 0 (forward and backward), at the CC shapes."""
    import torch

    from vilbert_tpu_torch.ops.attention import (
        attention,
        attention_bwd,
        attention_bwd_ref,
        attention_ref,
        bwd_variant,
        fused_attention,
        fwd_variant,
    )

    B = 8
    for heads, d, sq, sk in CC_ATTENTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, cot, bias = _attention_operands(g, B, heads, d, sq, sk, dtype)
            shape = f"h={heads} d={d} Sq={sq} Sk={sk} {name}"
            kw = dict(num_heads=heads, dropout_rate=0.1, seed=DROPOUT_SEED)
            variant = fwd_variant(dtype, sq, sk, d)
            got, on_variant = counted(attention, variant, lambda: attention(q, k, v, bias, **kw))
            want = attention_ref(q, k, v, bias, **kw)
            torch.cuda.synchronize()
            e, bound, ok = _fwd_error(got, want, name)
            track_error(err, "attention_fwd", variant, e)
            checks.expect(ok and on_variant, f"attention fwd rate 0.1 {shape} [{variant}]: "
                                             f"max|err| {e:.3e} (<= {bound:.3e})")
            for rate in (0.0, 0.1):
                kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
                variant = bwd_variant(dtype, sq, sk, d)
                got, on_variant = counted(attention_bwd, variant,
                                          lambda: attention_bwd(q, k, v, bias, cot, **kw))
                want = attention_bwd_ref(q, k, v, bias, cot, **kw)
                torch.cuda.synchronize()
                e, ok = _bwd_errors(got, want, name, bias)
                track_error(err, "attention_bwd", variant, e)
                checks.expect(ok and on_variant,
                              f"attention bwd rate {rate} {shape} [{variant}]: max|err| {e:.3e}")
            # the K3 entry: K1 and K2 at rate 0 through autograd
            qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
            out = fused_attention(qt, kt, vt, bias, num_heads=heads)
            out.backward(cot)
            torch.cuda.synchronize()
            e, bound, ok = _fwd_error(out.detach(), attention_ref(q, k, v, bias, num_heads=heads),
                                      name)
            eb, okb = _bwd_errors((qt.grad, kt.grad, vt.grad),
                                  attention_bwd_ref(q, k, v, bias, cot, num_heads=heads), name,
                                  bias)
            err["fused_attention"] = max(err["fused_attention"], e, eb)
            checks.expect(ok and okb, f"fused_attention fwd+bwd {shape}: max|err| {e:.3e}, "
                                      f"grads {eb:.3e}")


#: the wgmma K2's edges: its tiles of 64 rows (32 keys in the dq kernel at
#: d = 128; full, one short, one over), the tail narrowed to 16, 32, 48 or
#: 64 rows (1, 15, 16, 17, 63, 65, 127, 129, 131), the paths' lengths (200,
#: 257, 306, 562) and the cap (1024)
WG_EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 131, 200, 257, 306, 562, 1023,
                   1024)


def wg_edge_cases() -> list:
    """(heads, head_dim, Sq, Sk) of the wgmma K2's check: each edge length
    against itself and against the list reversed (unequal pairs: 1 x 1024,
    15 x 1023, ...), at d = 64 (h12) and d = 128 (h8) in turn."""
    pairs = [(s, s) for s in WG_EDGE_LENGTHS]
    pairs += [(a, b) for a, b in zip(WG_EDGE_LENGTHS, reversed(WG_EDGE_LENGTHS)) if a != b]
    return [(12, 64, sq, sk) if i % 2 else (8, 128, sq, sk) for i, (sq, sk) in enumerate(pairs)]


def _lse_error(lse, q, k, bias, heads) -> tuple:
    """(max|err|, ok) of K1's row log-sum-exps against torch.logsumexp of
    the plain fp32 scores: 1e-4 + 1e-6 |ref| (a fully padded row's scores
    sit at -10000, where fp32 spacing is 2^-10)."""
    import torch

    from vilbert_tpu_torch.ops.attention import _bias_rows, _heads

    d = q.shape[-1] // heads
    s = _heads(q, heads) @ _heads(k, heads).transpose(-1, -2) * (1.0 / math.sqrt(d))
    ref = torch.logsumexp(s + _bias_rows(bias, q, k.shape[1])[:, None, None, :], -1)
    diff = (lse - ref).abs()
    return float(diff.max()), bool((diff <= 1e-4 + 1e-6 * ref.abs()).all())


def phase_wg_kernels(checks: Checks, g, err: dict) -> None:
    """The wgmma K2 (``wg``) against ``attention_bwd_ref`` at
    ``wg_edge_cases()``, rates 0 and 0.1, with padded keys and a fully
    padded batch row, from the forward's output and row log-sum-exps (K1's
    ``tc`` or ``long_tc`` with ``return_lse``, each LSE checked against
    torch.logsumexp); every launch on ``launches_wg`` and two launches
    bit-identical; a stride-0 batch cotangent and bias; a misaligned operand
    refused."""
    import torch

    from vilbert_tpu_torch.ops.attention import (
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_kernel,
        attention_ref,
        fwd_variant,
    )

    B = 2
    for heads, d, sq, sk in wg_edge_cases():
        q, k, v, cot, bias = _attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        shape = f"h={heads} d={d} Sq={sq} Sk={sk}"
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            fv = fwd_variant(torch.bfloat16, sq, sk, d)
            out, lse = attention_kernel(q, k, v, bias, variant=fv, return_lse=True, **kw)
            e, bound, ok = _fwd_error(out, attention_ref(q, k, v, bias, **kw), "bfloat16")
            el, okl = _lse_error(lse, q, k, bias, heads)
            track_error(err, "attention_fwd", fv, e)

            def launch():
                return attention_bwd_kernel(q, k, v, bias, cot, variant="wg", out=out, lse=lse,
                                            **kw)

            got, on_wg = counted(attention_bwd, "wg", launch)
            again = launch()
            want = attention_bwd_ref(q, k, v, bias, cot, **kw)
            torch.cuda.synchronize()
            eb, okb = _bwd_errors(got, want, "bfloat16")
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            track_error(err, "attention_bwd", "wg", eb)
            checks.expect(ok and okl and okb and on_wg and same,
                          f"wg {shape} rate {rate}: fwd [{fv}] max|err| {e:.3e} (<= "
                          f"{bound:.3e}), lse max|err| {el:.3e}, bwd max|err| {eb:.3e}, "
                          f"bit-identical twice {same}")
    # the mma.sync variant "wg" took over past 128, named, at the long edges
    for heads, d, sq, sk in LONG_EDGE_CASES:
        q, k, v, cot, bias = _attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            got, on_lt = counted(attention_bwd, "long_tc", lambda: attention_bwd_kernel(
                q, k, v, bias, cot, variant="long_tc", **kw))
            eb, okb = _bwd_errors(got, attention_bwd_ref(q, k, v, bias, cot, **kw), "bfloat16")
            track_error(err, "attention_bwd", "long_tc", eb)
            checks.expect(okb and on_lt, f"attention bwd h={heads} d={d} Sq={sq} Sk={sk} rate "
                                         f"{rate} [long_tc, named]: max|err| {eb:.3e}")
    # a cotangent and a bias broadcast over the batch (stride 0)
    q, k, v, cot, bias = _attention_operands(g, 4, 8, 128, 200, 131, torch.bfloat16)
    cot = cot[:1].expand_as(cot)
    bias = bias[:1].expand_as(bias)
    got, on_wg = counted(attention_bwd, "wg", lambda: attention_bwd_kernel(
        q, k, v, bias, cot, variant="wg", num_heads=8))
    eb, okb = _bwd_errors(got, attention_bwd_ref(q, k, v, bias, cot, num_heads=8), "bfloat16")
    track_error(err, "attention_bwd", "wg", eb)
    checks.expect(okb and on_wg and cot.stride(0) == 0,
                  f"wg stride-0 batch g and bias 200x131: max|err| {eb:.3e}")
    # rows that start 2 bytes off a 16-byte boundary are refused, not rerouted
    wide = torch.randn(2, 200, 1025, generator=g, device=DEVICE).bfloat16()
    before = attention_bwd.launches
    try:
        attention_bwd(wide[..., 1:], wide[..., 1:], wide[..., 1:], None, wide[..., 1:],
                      num_heads=8)
        refused = False
    except ValueError:
        refused = True
    checks.expect(refused and attention_bwd.launches == before,
                  "wg refuses a bf16 operand that is not 16-byte aligned")


#: K1 wg's edges, in Sq and in Sk: one row or key, a 16-key step and one
#: over, one short of, at and one past a warpgroup's 64 rows and a 64-key
#: tile, the exact branch's end (128) and one past it, the paths' long
#: lengths (200, 257, 306, 562) and the cap
WG_FWD_EDGE_LENGTHS = (1, 16, 17, 63, 64, 65, 127, 128, 129, 200, 257, 306, 562, 1024)


def wg_fwd_edge_cases() -> list:
    """(heads, head_dim, Sq, Sk) of K1 wg's check: each edge length against
    itself and against the list reversed (1 x 1024, 16 x 562, ...), each at
    d = 64 (h12) and d = 128 (h8)."""
    pairs = [(s, s) for s in WG_FWD_EDGE_LENGTHS]
    pairs += [(a, b) for a, b in zip(WG_FWD_EDGE_LENGTHS, reversed(WG_FWD_EDGE_LENGTHS))
              if a != b]
    return [(heads, d, sq, sk) for sq, sk in pairs for heads, d in ((12, 64), (8, 128))]


def phase_wg_fwd_kernels(checks: Checks, g, err: dict) -> None:
    """K1's wgmma variant (``wg``) by name against ``attention_ref`` at
    ``wg_fwd_edge_cases()``, rates 0 and 0.1, with padded keys and a fully
    padded batch row: the output within the bf16 bound, the row
    log-sum-exps within ``_lse_error``'s, K2 ``wg`` fed from its output
    and log-sum-exps within K2's bound, and the probabilities (a second
    launch that also writes them) within ``_probs_error``'s bound, its
    output bit-equal to the first's; every launch on ``launches_wg``. A
    stride-0 batch k and v (retrieval's fast_mode) at both head widths; a
    misaligned operand refused."""
    import torch

    from vilbert_tpu_torch.ops.attention import (
        attention,
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_kernel,
        attention_ref,
    )

    B = 2
    for heads, d, sq, sk in wg_fwd_edge_cases():
        q, k, v, cot, bias = _attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        shape = f"h={heads} d={d} Sq={sq} Sk={sk}"
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            (out, lse), on_wg = counted(attention, "wg", lambda: attention_kernel(
                q, k, v, bias, variant="wg", return_lse=True, **kw))
            e, bound, ok = _fwd_error(out, attention_ref(q, k, v, bias, **kw), "bfloat16")
            el, okl = _lse_error(lse, q, k, bias, heads)
            got, on_bwd = counted(attention_bwd, "wg", lambda: attention_bwd_kernel(
                q, k, v, bias, cot, variant="wg", out=out, lse=lse, **kw))
            eb, okb = _bwd_errors(got, attention_bwd_ref(q, k, v, bias, cot, **kw), "bfloat16")
            (out_p, probs), on_p = counted(attention, "wg", lambda: attention_kernel(
                q, k, v, bias, variant="wg", return_probs=True, **kw))
            ep, ratio, okp = _probs_error(probs, attention_ref(q, k, v, bias, return_probs=True,
                                                               **kw)[1], "bfloat16", bias)
            torch.cuda.synchronize()
            same = torch.equal(out_p, out)
            track_error(err, "attention_fwd", "wg", e)
            track_error(err, "attention_bwd", "wg", eb)
            track_error(err, "attention_fwd_probs", "wg", ep)
            checks.expect(ok and okl and okb and okp and same and on_wg and on_bwd and on_p,
                          f"wg K1 {shape} rate {rate}: max|err| {e:.3e} (<= {bound:.3e}), lse "
                          f"max|err| {el:.3e}, K2 wg from its output and lse max|err| {eb:.3e}, "
                          f"P worst err/bound {ratio:.3f}, output with P bit-equal {same}")
    # one text broadcast over the batch (stride 0 in k and v)
    for hd, heads in ((768, 12), (1024, 8)):
        for sk in (30, 101, 200):
            q = torch.randn(4, 23, hd, generator=g, device=DEVICE).bfloat16()
            kv = torch.randn(1, sk, hd, generator=g, device=DEVICE).bfloat16().expand(4, sk, hd)
            got, on_wg = counted(attention, "wg", lambda: attention_kernel(
                q, kv, kv, None, num_heads=heads, variant="wg"))
            want = attention_ref(q, kv, kv, None, num_heads=heads)
            e, bound, ok = _fwd_error(got, want, "bfloat16")
            track_error(err, "attention_fwd", "wg", e)
            checks.expect(ok and on_wg and kv.stride(0) == 0,
                          f"wg stride-0 batch k, v h={heads} Sk={sk}: max|err| {e:.3e} <= "
                          f"{bound:.3e}")
    # 16-byte copies: rows that start 2 bytes off are refused, not rerouted
    wide = torch.randn(2, 101, 1025, generator=g, device=DEVICE).bfloat16()
    before = attention.launches
    try:
        attention_kernel(wide[..., 1:], wide[..., 1:], wide[..., 1:], None, num_heads=8,
                         variant="wg")
        refused = False
    except ValueError:
        refused = True
    checks.expect(refused and attention.launches == before,
                  "wg refuses a bf16 operand that is not 16-byte aligned")


def ln_edge_rows(dtype) -> tuple:
    """K4's row counts at the edges for ``dtype``: 1, 2, a warp less one,
    the SM count, LN_ROWS and the variants' two crossovers +- 1."""
    from vilbert_tpu_torch.ops.layernorm import PERSISTENT_MAX_ROWS, PERSISTENT_MIN_ROWS

    return (1, 2, 31, 132, LN_ROWS, *(n + d for n in (PERSISTENT_MIN_ROWS,
                                                     PERSISTENT_MAX_ROWS[dtype])
                                      for d in (-1, 0, 1)))


def phase_layer_norm_kernels(checks: Checks, g, err: dict) -> None:
    """Every K4 variant, named, and the routed call against
    ``layer_norm_ref`` at LN_EDGE_WIDTHS x ``ln_edge_rows(dtype)``, with and
    without a residual, fp32 (1e-4) and bf16 (``bf16_bound``) x, weight and
    bias fp32 and bf16 (the bf16-weight instantiation), each call on its
    variant's counter and, with bf16 weights, on ``launches_bf16_weight``;
    a misaligned operand refused."""
    import torch

    from vilbert_tpu_torch.ops.layernorm import (
        VARIANTS,
        layer_norm,
        layer_norm_kernel,
        layer_norm_ref,
        ln_variant,
    )

    # the bf16-weight cases draw from their own generator: ``g`` goes on to
    # the attention cases with the stream it had before them
    g_bf16_weight = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    for h in LN_EDGE_WIDTHS:
        w32 = 1 + 0.1 * torch.randn(h, generator=g, device=DEVICE)
        b32 = 0.1 * torch.randn(h, generator=g, device=DEVICE)
        for wdtype in (torch.float32, torch.bfloat16):
            w, b = w32.to(wdtype), b32.to(wdtype)
            bf16_w = wdtype == torch.bfloat16
            err_key = "layer_norm_fwd_bf16_weight" if bf16_w else "layer_norm_fwd"
            gx = g_bf16_weight if bf16_w else g
            for dtype in (torch.float32, torch.bfloat16):
                for rows in ln_edge_rows(dtype):
                    x = (2 * torch.randn(rows, h, generator=gx, device=DEVICE) + 0.5).to(dtype)
                    res = torch.randn(rows, h, generator=gx, device=DEVICE).to(dtype)
                    routed = ln_variant(rows, h, dtype)
                    worst, failed = {}, []
                    for r in (None, res):
                        want = layer_norm_ref(x, w, b, residual=r).float()
                        bound = 1e-4 if dtype == torch.float32 else bf16_bound(want)
                        calls = {v: (v, lambda v=v: layer_norm_kernel(x, w, b, residual=r,
                                                                      variant=v))
                                 for v in VARIANTS}
                        calls["routed"] = (routed, lambda: layer_norm(x, w, b, residual=r))
                        for name, (variant, fn) in calls.items():
                            before = layer_norm.launches_bf16_weight
                            got, on_variant = counted(layer_norm, variant, fn)
                            on_variant &= layer_norm.launches_bf16_weight - before == bf16_w
                            torch.cuda.synchronize()
                            e = float((got.float() - want).abs().max())
                            worst[name] = max(worst.get(name, 0.0), e)
                            err[err_key] = max(err[err_key], e)
                            if not (e <= bound and on_variant and got.dtype == dtype):
                                failed.append(f"{name} residual={r is not None}: {e:.3e} > "
                                              f"{bound:.3e} or not on {variant}")
                    checks.expect(not failed, f"layer_norm H={h} rows={rows} {str(dtype)[6:]} "
                                              f"weight {str(wdtype)[6:]} (routed {routed}), "
                                              "max|err| " + ", ".join(
                                                  f"{k} {e:.3e}" for k, e in worst.items())
                                  + (f": {failed}" if failed else ""))
    # 16-byte vectors: a row that starts 2 bytes off is refused
    x = torch.zeros(4 * 768 + 1, dtype=torch.bfloat16, device=DEVICE)[1:].view(4, 768)
    try:
        layer_norm(x, torch.ones(768, device=DEVICE), torch.zeros(768, device=DEVICE))
        refused = False
    except ValueError:
        refused = True
    checks.expect(refused, "layer_norm refuses a bf16 operand that is not 16-byte aligned")


#: (label, rows, width) of the FFN activations gelu_rational runs over, one
#: of each cell's (B x positions, intermediate size): CC text and image,
#: the baseline's CC step, VQA text and image at B=1024, a 12-in-1 task
#: (RetrievalCOCO's text, 512 x 31), the demo (B=1), and an odd length for
#: the kernels' scalar tail
GELU_SHAPES = (("CC text", 256 * 36, 3072), ("CC image", 256 * 37, 1024),
               ("baseline CC", 256 * 73, 3072), ("VQA text", 1024 * 23, 3072),
               ("VQA image", 1024 * 101, 1024), ("T7,T8 text", 512 * 31, 3072),
               ("demo text", 30, 3072), ("odd length", 1, 1_000_003))
GELU_FP32_SAMPLE = (1 << 20) + 5


def same_bits(got, want) -> int:
    """Elements whose bits differ, NaN against NaN counted equal."""
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[got.dtype]
    differ = (got.view(ints) != want.view(ints)) & ~(got.isnan() & want.isnan())
    return int(differ.sum())


def phase_gelu_kernels(checks: Checks) -> None:
    """The rational gelu's kernels against the plain chain run on the card
    (``gelu_rational_ref``, ``gelu_rational_bwd_ref``), bit for bit: every
    bf16 pattern as x with a random bf16 cotangent, GELU_FP32_SAMPLE fp32
    values across +-8 with the edges (signed zeros, infinities, NaN,
    subnormals, the clamps), and each of GELU_SHAPES in bf16; the forward
    through ``gelu_rational``, the backward through ``gelu_rational_bwd``
    and through autograd, each call on its counter; a misaligned,
    non-contiguous or fp16 operand refused, uncounted. Then each shape
    timed: kernel, plain chain and the exact gelu's library kernels
    (``F.gelu``, ``aten.gelu_backward``: another function, a yardstick of
    one eager pass) against the byte bound (x read, y written; x and dy
    read, dx written). Its inputs come from a generator of its own, so that
    the phases after it draw what they drew before it."""
    import torch
    import torch.nn.functional as F

    from vilbert_tpu_torch.ops.gelu import (
        gelu_rational,
        gelu_rational_bwd,
        gelu_rational_bwd_ref,
        gelu_rational_ref,
    )

    def counts():
        return gelu_rational.launches, gelu_rational.launches_bwd

    def check_bits(what, x, dy):
        before = counts()
        y = gelu_rational(x)
        dx = gelu_rational_bwd(x, dy)
        xr = x.detach().clone().requires_grad_()
        y_ad = gelu_rational(xr)
        (dx_ad,) = torch.autograd.grad(y_ad, xr, dy)
        torch.cuda.synchronize()
        want_y, want_dx = gelu_rational_ref(x), gelu_rational_bwd_ref(x, dy)
        bad = {"fwd": same_bits(y, want_y), "bwd": same_bits(dx, want_dx),
               "autograd fwd": same_bits(y_ad.detach(), want_y),
               "autograd bwd": same_bits(dx_ad, want_dx)}
        on_counters = counts() == (before[0] + 2, before[1] + 2)
        checks.expect(not any(bad.values()) and on_counters and y.dtype == dx.dtype == x.dtype,
                      f"gelu_rational {what}: elements differing from the plain chain "
                      f"{bad}, launches fwd / bwd +{counts()[0] - before[0]} / "
                      f"+{counts()[1] - before[1]} (want +2 / +2)")

    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    # every bf16 bit pattern
    x = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    x = x.view(torch.bfloat16)
    check_bits("every bf16 pattern", x,
               torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16))
    # fp32 across +-8, with the edges
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40,
                          1e-45, -3.4e38, 3.2 * 2 ** 0.5, -3.2 * 2 ** 0.5, 4.5255, 5.0, -5.0,
                          5.000001], device=dev)
    x = torch.cat([16 * torch.rand(GELU_FP32_SAMPLE, generator=g, device=dev) - 8, edges])
    check_bits(f"{x.numel()} fp32 values", x, torch.randn(x.shape, generator=g, device=dev))
    for label, rows, width in GELU_SHAPES:
        x = (2 * torch.randn(rows, width, generator=g, device=dev)).to(torch.bfloat16)
        dy = torch.randn(rows, width, generator=g, device=dev).to(torch.bfloat16)
        check_bits(f"{label} {rows}x{width} bf16", x, dy)
    # refused before any launch
    wide = torch.zeros(64 * 3072 + 1, dtype=torch.bfloat16, device=dev)
    dense = wide[:-1].view(64, 3072)
    refusals = {"misaligned x": lambda: gelu_rational(wide[1:].view(64, 3072)),
                "non-contiguous x": lambda: gelu_rational(dense[:, ::2]),
                "fp16 x": lambda: gelu_rational(dense.half()),
                "misaligned dy": lambda: gelu_rational_bwd(dense, wide[1:].view(64, 3072))}
    for what, fn in refusals.items():
        before = counts()
        try:
            fn()
            refused = False
        except ValueError:
            refused = True
        checks.expect(refused and counts() == before, f"gelu_rational refuses a {what}")

    with torch.inference_mode():
        for label, rows, width in GELU_SHAPES:
            x = (2 * torch.randn(rows, width, generator=g, device=dev)).to(torch.bfloat16)
            dy = torch.randn(rows, width, generator=g, device=dev).to(torch.bfloat16)
            n, elt = x.numel(), x.element_size()
            for kind, fns, nbytes in (
                    ("fwd", {"kernel": lambda: gelu_rational(x),
                             "plain": lambda: gelu_rational_ref(x),
                             "library": lambda: F.gelu(x)}, 2 * n * elt),
                    ("bwd", {"kernel": lambda: gelu_rational_bwd(x, dy),
                             "plain": lambda: gelu_rational_bwd_ref(x, dy),
                             "library": lambda: torch.ops.aten.gelu_backward(dy, x)},
                     3 * n * elt)):
                row = timed_row(fns, "kernel", "plain", nbytes, 0, FP32_FLOPS, library="library")
                log(f"  gelu_rational {kind} {label} {rows}x{width} bf16, "
                    f"{nbytes / 1e6:.1f} MB: " + row_text(row))


#: (label, shape) of the hidden-state dropout sites hash_dropout runs
#: over, one of each training cell's: CC text and image streams, the
#: baseline's joint sequence, the 12-in-1 iteration's largest (T7,T8's
#: image stream at 512 x 101), and an odd length for the kernels' scalar
#: tail
DROPOUT_SHAPES = (("CC text", (256, 36, 768)), ("CC image", (256, 37, 1024)),
                  ("baseline CC", (256, 73, 768)), ("T7,T8 image", (512 * 101, 1024)),
                  ("odd length", (1_000_003,)))
#: bytes of inputs a timed dropout row cycles through: three L2s, so that
#: each call reads its operand from device memory, as a site does
DROPOUT_ROTATION_BYTES = 150e6


def phase_dropout_kernels(checks: Checks) -> None:
    """The hidden-state dropout's kernels (``csrc/dropout.cu``) against the
    plain int64 chain run on the card (``hash_dropout_ref`` and autograd's
    where / div backward of it), bit for bit: every bf16 pattern as x with
    a random bf16 cotangent at rates 0.1 and 0.5, at offset 0 and across
    the flat index's wrap at 2^32; fp32 values with the edges (signed
    zeros, infinities, NaN, subnormals); each of DROPOUT_SHAPES in bf16 and
    the CC text shape in fp32 (the embeddings' dropout runs on the fp32
    LayerNorm output); a strided x through ``hash_dropout``. The forward
    through ``hash_dropout``, the backward through ``_bwd_cuda`` and
    through autograd, each call on its counter; no int64 or boolean tensor
    made on the way; a misaligned, strided or fp16 operand refused by the
    launchers, uncounted. Then each shape timed: kernel, plain chain and
    PyTorch's own dropout (``native_dropout`` and its backward: another
    mask, a yardstick of one eager pass) against the byte bound (the
    operand read, the result written). Its inputs come from a generator of
    its own, so that the phases after it draw what they drew before it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from vilbert_tpu_torch.ops.dropout import (
        _bwd_cuda,
        _fwd_cuda,
        hash_dropout,
        hash_dropout_ref,
        hash_keep_mask,
    )

    class DtypesMade(TorchDispatchMode):
        """The dtypes of every tensor the operators under it return."""

        def __init__(self):
            super().__init__()
            self.dtypes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.dtypes |= {t.dtype for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
            return out

    def counts():
        return hash_dropout.launches, hash_dropout.launches_bwd

    def check_bits(what, x, g, rate, seed, offset=0):
        before = counts()
        y = hash_dropout(x, rate, seed, offset)
        dx = _bwd_cuda(g, rate, seed, offset)
        xr = x.detach().clone().requires_grad_()
        with DtypesMade() as made:
            y_ad = hash_dropout(xr, rate, seed, offset)
            (dx_ad,) = torch.autograd.grad(y_ad, xr, g)
        xp = x.detach().clone().requires_grad_()
        want_y = hash_dropout_ref(xp, rate, seed, offset)
        (want_dx,) = torch.autograd.grad(want_y, xp, g)
        torch.cuda.synchronize()
        want_y = want_y.detach()
        bad = {"fwd": same_bits(y, want_y), "bwd": same_bits(dx, want_dx),
               "autograd fwd": same_bits(y_ad.detach(), want_y),
               "autograd bwd": same_bits(dx_ad, want_dx)}
        on_counters = counts() == (before[0] + 2, before[1] + 2)
        kept = float((want_y != 0).float().mean())
        checks.expect(not any(bad.values()) and on_counters and made.dtypes == {x.dtype}
                      and y.dtype == dx.dtype == x.dtype,
                      f"hash_dropout {what}, rate {rate}, offset {offset}: elements differing "
                      f"from the plain chain {bad}, launches fwd / bwd "
                      f"+{counts()[0] - before[0]} / +{counts()[1] - before[1]} (want +2 / +2), "
                      f"dtypes made {sorted(map(str, made.dtypes))}, nonzero share {kept:.4f}")

    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    cpu = torch.Generator().manual_seed(SEED + 19)

    def seed():
        return int(torch.randint(2 ** 31, 2 ** 32, (), generator=cpu))

    # every bf16 bit pattern, at two rates, from index 0 and across the wrap
    x = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    x = x.view(torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device=dev).to(torch.bfloat16)
    for rate in (0.1, 0.5):
        for offset in (0, 2 ** 32 - x.numel() // 2):
            check_bits("every bf16 pattern", x, gy, rate, seed(), offset)
    # fp32 with the edges
    edges = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40,
                          1e-45, -3.4e38, 3.4e38, 1.0, -1.0], device=dev)
    x = torch.cat([16 * torch.rand(1 << 20, generator=g, device=dev) - 8, edges])
    gy = torch.randn(x.shape, generator=g, device=dev)
    for rate in (0.1, 0.5):
        check_bits(f"{x.numel()} fp32 values", x, gy, rate, seed(), 2 ** 32 - 7)
    # each site shape; the largest across the wrap, as a data rank's block
    for label, shape in DROPOUT_SHAPES:
        x = (2 * torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
        gy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        offset = 2 ** 32 - x.numel() // 2 if label == "T7,T8 image" else x.numel()
        check_bits(f"{label} {shape} bf16", x, gy, 0.1, seed(), offset)
    label, shape = DROPOUT_SHAPES[0]
    x = torch.randn(shape, generator=g, device=dev)
    check_bits(f"{label} {shape} fp32", x, torch.randn(shape, generator=g, device=dev), 0.1,
               seed())
    # a strided x: hash_dropout hashes its logical flat index over a dense copy
    wide = torch.randn(64, 2 * 768, generator=g, device=dev).to(torch.bfloat16)
    s = seed()
    before = counts()
    y = hash_dropout(wide[:, ::2], 0.1, s)
    keep = hash_keep_mask((64, 768), 0.1, s, device=dev)
    checks.expect(same_bits(y, hash_dropout_ref(wide[:, ::2], 0.1, s)) == 0
                  and counts() == (before[0] + 1, before[1]) and bool((y[~keep] == 0).all()),
                  "hash_dropout over a strided x: its logical flat index, bit-equal")
    # refused before any launch
    flat = torch.zeros(64 * 768 + 1, dtype=torch.bfloat16, device=dev)
    dense = flat[:-1].view(64, 768)
    refusals = {"misaligned x": lambda: _fwd_cuda(flat[1:].view(64, 768), 0.1, 1),
                "strided x": lambda: _fwd_cuda(wide[:, ::2], 0.1, 1),
                "fp16 x": lambda: hash_dropout(dense.half(), 0.1, 1),
                "misaligned cotangent": lambda: _bwd_cuda(flat[1:].view(64, 768), 0.1, 1),
                "strided cotangent": lambda: _bwd_cuda(wide[:, ::2], 0.1, 1)}
    for what, fn in refusals.items():
        before = counts()
        try:
            fn()
            refused = False
        except ValueError:
            refused = True
        checks.expect(refused and counts() == before, f"hash_dropout refuses a {what}")

    def cycled(tensors):
        it = itertools.cycle(tensors)
        return lambda: next(it)

    with torch.inference_mode():
        for label, shape, dtype in (*((lb, sh, torch.bfloat16) for lb, sh in DROPOUT_SHAPES),
                                    (*DROPOUT_SHAPES[0], torch.float32)):
            n = math.prod(shape)
            elt = torch.finfo(dtype).bits // 8
            copies = max(1, math.ceil(DROPOUT_ROTATION_BYTES / (n * elt)))
            xs = cycled([(2 * torch.randn(shape, generator=g, device=dev)).to(dtype)
                         for _ in range(copies)])
            s = seed()
            keep = hash_keep_mask(shape, 0.1, s, device=dev)
            divisor = torch.full((), 0.9, dtype=dtype, device=dev)
            for kind, fns in (
                    ("fwd", {"kernel": lambda: _fwd_cuda(xs(), 0.1, s),
                             "plain": lambda: hash_dropout_ref(xs(), 0.1, s),
                             "library": lambda: torch.ops.aten.native_dropout(xs(), 0.1, True)}),
                    ("bwd", {"kernel": lambda: _bwd_cuda(xs(), 0.1, s),
                             "plain": lambda: torch.where(keep, xs(), 0.0) / divisor,
                             "library": lambda: torch.ops.aten.native_dropout_backward(
                                 xs(), keep, 1 / 0.9)})):
                nbytes = 2 * n * elt
                row = timed_row(fns, "kernel", "plain", nbytes, 0, FP32_FLOPS, library="library")
                log(f"  hash_dropout {kind} {label} {shape} {str(dtype)[6:]}, "
                    f"{nbytes / 1e6:.1f} MB, {copies} operand(s) in turn: " + row_text(row))
            del xs, keep


def phase_kernels(checks: Checks) -> dict:
    import torch

    from vilbert_tpu_torch.ops.attention import (
        attention,
        attention_kernel,
        attention_ref,
        fwd_variant,
        make_additive_mask,
    )

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    dev = DEVICE
    # K1's long tensor-core and CUDA-core variants and the long tensor-core
    # K2 also on their own
    err = {"attention_fwd": 0.0, "attention_bwd": 0.0, "fused_attention": 0.0,
           "layer_norm_fwd": 0.0, "layer_norm_fwd_bf16_weight": 0.0,
           "attention_fwd_long_tc": 0.0, "attention_fwd_cc": 0.0, "attention_bwd_long_tc": 0.0,
           "attention_bwd_wg": 0.0, "attention_fwd_probs": 0.0, "attention_fwd_wg": 0.0}
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
            variant = fwd_variant(dtype, sq, sk, d)
            got, on_variant = counted(attention, variant,
                                      lambda: attention(q, k, v, bias, num_heads=heads))
            want = attention_ref(q, k, v, bias, num_heads=heads)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            bound = 1e-4 if dtype == torch.float32 else bf16_bound(want.float())
            track_error(err, "attention_fwd", variant, e)
            checks.expect(e <= bound and on_variant,
                          f"attention h={heads} d={d} Sq={sq} Sk={sk} {str(dtype)[6:]} "
                          f"[{variant}]: max|err| {e:.3e} <= {bound:.3e}")
    # the long tensor-core K1's tiling edges, at rates 0 and 0.1, by name
    for heads, d, sq, sk in LONG_FWD_EDGE_CASES:
        q, k, v, _, bias = _attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            got, on_variant = counted(attention, "long_tc", lambda: attention_kernel(
                q, k, v, bias, variant="long_tc", **kw))
            want = attention_ref(q, k, v, bias, **kw)
            torch.cuda.synchronize()
            e, bound, ok = _fwd_error(got, want, "bfloat16")
            track_error(err, "attention_fwd", "long_tc", e)
            checks.expect(ok and on_variant, f"attention h={heads} d={d} Sq={sq} Sk={sk} bf16 "
                                             f"rate {rate} [long_tc]: max|err| {e:.3e} <= "
                                             f"{bound:.3e}")
    # retrieval's fast_mode broadcasts one text over the batch: a stride-0
    # batch in k and v reaches the tensor-core kernels as it is
    for sk, variant in ((30, "tc"), (200, "long_tc")):
        q = torch.randn(B, 23, 768, generator=g, device=dev).bfloat16()
        kv = torch.randn(1, sk, 768, generator=g, device=dev).bfloat16().expand(B, sk, 768)
        got, on_variant = counted(attention, variant, lambda: attention_kernel(
            q, kv, kv, None, num_heads=12, variant=variant))
        want = attention_ref(q, kv, kv, None, num_heads=12)
        e, bound = float((got.float() - want.float()).abs().max()), bf16_bound(want.float())
        track_error(err, "attention_fwd", variant, e)
        checks.expect(e <= bound and on_variant, f"attention stride-0 batch k, v Sk={sk} bf16 "
                                                 f"[{variant}]: max|err| {e:.3e} <= {bound:.3e}")
    # the tensor-core kernels copy 16-byte chunks: a row that starts 2 bytes
    # off is refused, not sent elsewhere
    for sk in (23, 200):
        wide = torch.randn(B, sk, 769, generator=g, device=dev).bfloat16()
        try:
            attention(wide[:, :23, 1:], wide[..., 1:], wide[..., 1:], None, num_heads=12)
            refused = False
        except ValueError:
            refused = True
        checks.expect(refused, f"attention refuses a bf16 operand that is not 16-byte aligned "
                               f"[{fwd_variant(torch.bfloat16, 23, sk, 64)}]")
    phase_layer_norm_kernels(checks, g, err)
    phase_gelu_kernels(checks)
    phase_dropout_kernels(checks)
    phase_training_kernels(checks, g, err)
    phase_wg_kernels(checks, g, err)
    phase_wg_fwd_kernels(checks, g, err)
    checks.end_phase("kernels")
    return err


# -- phase 4 -----------------------------------------------------------------

_COCO_100 = "datasets/coco/features_100/COCO_trainval_resnext152_faster_rcnn_genome.lmdb"
_FLICKR = "datasets/flickr30k/flickr30k_resnext152_faster_rcnn_genome.lmdb"
_REFCOCO = "datasets/refcoco/{0}/{1}_{2}resnext152_faster_rcnn_genome.lmdb"
#: the flagship recipe's entries of configs/tasks.yml, the fields that are
#: not TaskConfig's defaults (built here: the card has no PyYAML;
#: tests/test_torch_host.py holds them to the yml)
FLAGSHIP_TASKS = {
    "TASK1": dict(task_id=1, name="VQA", type="VL-classifier", loss="BCEWithLogitLoss",
                  dataroot="datasets/VQA/", features_path=_COCO_100, eval_batch_size=1024,
                  train_split="trainval", val_split="minval"),
    "TASK2": dict(task_id=2, name="GenomeQA", type="VL-classifier", loss="BCEWithLogitLoss",
                  dataroot="datasets/visual_genome/",
                  features_path="datasets/visual_genome/vg_resnext152_faster_rcnn_genome.lmdb",
                  max_seq_length=26, eval_batch_size=1024),
    "TASK4": dict(task_id=4, name="Visual7w", type="V-logit-mc", loss="BCEWithLogitLoss",
                  dataroot="datasets/visual7w",
                  features_path="datasets/visual7w/visual7w_resnext152_faster_rcnn_genome.lmdb",
                  features_path_gt="datasets/visual7w/visual7w_gt_resnext152_faster_rcnn_genome"
                                   ".lmdb",
                  max_seq_length=20, max_region_num=200, batch_size=256, lr=2e-05),
    "TASK7": dict(task_id=7, name="RetrievalCOCO", type="VL-logit", loss="CrossEntropyLoss",
                  process="retrieval", dataroot="datasets/cocoRetreival",
                  features_path=_COCO_100,
                  train_annotations_jsonpath="datasets/cocoRetreival/"
                                             "all_data_final_train_2014.jsonline",
                  val_annotations_jsonpath="datasets/cocoRetreival/"
                                           "all_data_final_test_set0_2014.jsonline",
                  max_seq_length=30, lr=2e-05),
    "TASK8": dict(task_id=8, name="RetrievalFlickr30k", type="VL-logit",
                  loss="CrossEntropyLoss", process="retrieval", dataroot="datasets/flickr30k",
                  features_path=_FLICKR,
                  train_annotations_jsonpath="datasets/flickr30k/"
                                             "all_data_final_train_2014.jsonline",
                  val_annotations_jsonpath="datasets/flickr30k/"
                                           "all_data_final_test_set0_2014.jsonline",
                  max_seq_length=30, lr=2e-05),
    **{f"TASK{n}": dict(task_id=n, name=name, type="V-logit", loss="BCEWithLogitLoss",
                        dataroot="datasets/refcoco",
                        features_path=_REFCOCO.format(folder, name, ""),
                        features_path_gt=_REFCOCO.format(folder, name, "gt_"),
                        max_seq_length=20, batch_size=256, lr=2e-05, **extra)
       for n, name, folder, extra in ((9, "refcoco", "refcoco_unc", {}),
                                      (10, "refcoco+", "refcoco+_unc",
                                       {"eval_batch_size": 1024}),
                                      (11, "refcocog", "refcocog_umd", {}))},
    "TASK12": dict(task_id=12, name="NLVR2", type="VL-binary-classifier",
                   loss="BCEWithLogitLoss", process="nlvr", dataroot="datasets/nlvr2/",
                   features_path="datasets/nlvr2/nlvr2_resnext152_faster_rcnn_genome.lmdb",
                   max_seq_length=40, batch_size=64, eval_batch_size=512, val_split="dev",
                   lr=2e-05),
    "TASK13": dict(task_id=13, name="VisualEntailment", type="VL-tri-classifier",
                   loss="BCEWithLogitLoss", dataroot="datasets/visual_entailment/",
                   features_path=_FLICKR, max_seq_length=56, batch_size=256,
                   eval_batch_size=1024, val_split="dev", lr=2e-05),
    "TASK15": dict(task_id=15, name="GQA", type="VL-classifier-GQA", loss="BCEWithLogitLoss",
                   dataroot="datasets/gqa/",
                   features_path="datasets/gqa/gqa_resnext152_faster_rcnn_genome.lmdb",
                   max_seq_length=26, eval_batch_size=1024, train_split="trainval",
                   val_split="minval"),
    "TASK17": dict(task_id=17, name="GuessWhatPointing", type="V-logit-mc",
                   loss="BCEWithLogitLoss", dataroot="datasets/guesswhat/",
                   features_path=_COCO_100,
                   features_path_gt="datasets/guesswhat/guesswhat_gt_resnext152_faster_rcnn"
                                    "_genome.lmdb",
                   max_seq_length=256, max_region_num=306, batch_size=64, val_split="valid",
                   lr=2e-05),
}


def flagship_tasks() -> dict:
    """{"TASKn": TaskConfig} of train_tasks --tasks 1-2-4-7-8-9-10-11-12-13-15-17."""
    from vilbert_tpu_torch.core.config import TaskConfig

    return {key: TaskConfig(**kw) for key, kw in FLAGSHIP_TASKS.items()}


def task1():
    """TASK1 of configs/tasks.yml (23 tokens, 101 regions)."""
    return flagship_tasks()["TASK1"]


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


def _counters() -> dict:
    """counter name -> (wrapper, attribute): each kernel's total, each
    variant's count, K4's bf16-weight launches and the rational gelu's and
    the hidden-state dropout's forward and backward launches."""
    from vilbert_tpu_torch.ops import dropout, gelu, layernorm, quant
    from vilbert_tpu_torch.ops.attention import (
        BWD_VARIANTS,
        VARIANTS,
        attention,
        attention_bwd,
    )

    out = {}
    for name, wrapper, variants in (("attention", attention, VARIANTS),
                                    ("attention_bwd", attention_bwd, BWD_VARIANTS),
                                    ("layer_norm", layernorm.layer_norm, layernorm.VARIANTS)):
        out[name] = (wrapper, "launches")
        for variant in variants:
            out[f"{name}_{variant}"] = (wrapper, f"launches_{variant}")
    # K4's bf16-weight instantiation (of either variant)
    out["layer_norm_bf16_weight"] = (layernorm.layer_norm, "launches_bf16_weight")
    # K1 launches that also wrote the probabilities (visualization), and the
    # int8 sites' torch._int_mm calls (a library GEMM, as the JAX package's
    # int8 dot is XLA's): all, and those on zero-padded operands
    out["attention_probs"] = (attention, "launches_probs")
    # the rational gelu's kernels, forward and backward
    out["gelu_rational"] = (gelu.gelu_rational, "launches")
    out["gelu_rational_bwd"] = (gelu.gelu_rational, "launches_bwd")
    # the hidden-state dropout's kernels, forward and backward
    out["hash_dropout"] = (dropout.hash_dropout, "launches")
    out["hash_dropout_bwd"] = (dropout.hash_dropout, "launches_bwd")
    out["int_mm"] = (quant.int_mm, "launches")
    out["int_mm_padded"] = (quant.int_mm, "launches_padded")
    return out


def reset_launches() -> None:
    for wrapper, attr in _counters().values():
        setattr(wrapper, attr, 0)


def read_launches() -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in _counters().items()}


@contextlib.contextmanager
def recording_ln_shapes():
    """Counts K4's launches by (rows, H, dtype name, residual) while open,
    through the wrapper's launch function (``layer_norm`` and
    ``layer_norm_kernel`` reach it by its module's name)."""
    from vilbert_tpu_torch.ops import layernorm

    launch, seen = layernorm._fwd_cuda, collections.Counter()

    def recorded(x, weight, bias, eps, residual, variant=None):
        out = launch(x, weight, bias, eps, residual, variant)
        seen[(x.numel() // x.shape[-1], x.shape[-1], str(x.dtype)[6:], residual is not None)] += 1
        return out

    layernorm._fwd_cuda = recorded
    try:
        yield seen
    finally:
        layernorm._fwd_cuda = launch


def ln_expected(shapes: dict, times: int = 1) -> tuple:
    """({(rows, H, dtype, residual): launches}, {counter: launches}) of
    ``shapes`` ({key: count}) run ``times`` times: the recording they give
    and the K4 counts, total and by the variant ``ln_variant`` picks."""
    import torch

    from vilbert_tpu_torch.ops.layernorm import VARIANTS, ln_variant

    counts = {"layer_norm": 0, **{f"layer_norm_{v}": 0 for v in VARIANTS}}
    for (rows, h, dtype, _), n in shapes.items():
        counts["layer_norm"] += n * times
        counts[f"layer_norm_{ln_variant(rows, h, getattr(torch, dtype))}"] += n * times
    return {key: n * times for key, n in shapes.items() if n}, counts


def check_ln_recording(checks: Checks, what: str, seen, shapes: dict, launches: dict,
                       times: int = 1) -> None:
    """K4's recorded shapes and its counters against ``shapes`` run
    ``times`` times."""
    want, counts = ln_expected(shapes, times)
    diff = {k: (seen.get(k, 0), want.get(k, 0)) for k in {*seen, *want}
            if seen.get(k, 0) != want.get(k, 0)}
    checks.expect(not diff, f"{what}: K4 launches by (rows, H, dtype, residual) as "
                            f"chip_smoke.ln_shapes says ({len(want)} shapes; recorded vs "
                            f"expected where they differ: {diff})")
    got = {name: launches[name] for name in counts}
    checks.expect(got == counts, f"{what}: K4 launches by variant {got} == {counts}")


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

    from vilbert_tpu_torch.cli.eval_tasks import build_model, run_eval, synthetic_vqa_loader
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    cfg = ModelConfig.from_json_file(CONFIG)  # bf16 compute, as the CLI runs it
    task = task1()
    t0 = time.time()
    model = build_model(cfg, seed=SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {CONFIG}: {n_params} params, compute {cfg.compute_dtype}, "
        f"built in {time.time() - t0:.1f} s")

    loader = synthetic_vqa_loader(cfg, task)
    n_batches = len(loader)
    with tempfile.TemporaryDirectory() as out_dir, recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        metrics, records = run_eval(model, cfg, {"TASK1": task}, {"TASK1": loader},
                                    output_dir=out_dir, split=task.val_split)["TASK1"]
        torch.cuda.synchronize()
        launches = read_launches()
        files = sorted(os.listdir(out_dir))
    log(f"  run_eval TASK1: loss {metrics['loss']:.6f} score {metrics['score']:.6f} "
        f"records {len(records)} samples {metrics['num_samples']} in {time.time() - t0:.1f} s; "
        f"files {files}; launches {launches}")
    want_attn, want_ln = kernel_calls_per_forward(cfg)
    check_k1(checks, f"run_eval, {n_batches} x {want_attn}", launches,
             k1_routed(vl_attention_shapes(cfg, T, R), n_batches), no_k2=False)
    checks.expect(launches["layer_norm"] == n_batches * want_ln,
                  f"layer_norm launches {launches['layer_norm']} == {n_batches} x {want_ln}")
    # the evaluator pads a short last batch to the batch size
    bs = loader.batch_size
    ln_want = {key: count for key, (_, count) in ln_forward(
        cfg, bs, T, R, [("classifier", bs, 2 * cfg.bi_hidden_size)]).items()}
    check_ln_recording(checks, "run_eval", ln_seen, ln_want, launches, n_batches)
    checks.expect(launches["attention_bwd"] == 0,
                  f"attention_bwd launches {launches['attention_bwd']} == 0")
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

def ln_forward(cfg, B: int, T: int, R: int, heads=(), *, fast: bool = False) -> dict:
    """K4's launches in one forward of B samples at T tokens and R regions,
    {(rows, H, dtype name, residual): (kind, count)}: the text embedding's
    in fp32; the image embedding's, and two a text or image layer and four a
    connection layer (two a stream, with the residual), in the compute
    dtype; ``heads`` adds (kind, rows, H) of the heads' LayerNorms (compute
    dtype, no residual). ``fast`` (retrieval's ``fast_mode``): one text runs
    at batch 1 up to the first co-attention layer, then at batch B."""
    dt, h_t, h_v = cfg.compute_dtype, cfg.hidden_size, cfg.v_hidden_size
    n_c = cfg.num_connection_layers
    n_pre = 0
    if fast:
        schedule = cfg.encoder_schedule()
        first_c = next(i for i, (kind, _) in enumerate(schedule) if kind == "c")
        n_pre = sum(kind == "t" for kind, _ in schedule[:first_c])
    out = {}
    for kind, rows, h, dtype, res, n in (
            ("text embedding", (1 if fast else B) * T, h_t, "float32", False, 1),
            ("text, batch 1", T, h_t, dt, True, 2 * n_pre),
            ("text", B * T, h_t, dt, True, 2 * (cfg.num_hidden_layers - n_pre) + 2 * n_c),
            ("image embedding", B * R, h_v, dt, False, 1),
            ("image", B * R, h_v, dt, True, 2 * cfg.v_num_hidden_layers + 2 * n_c),
            *((kind, rows, h, dt, False, 1) for kind, rows, h in heads)):
        if not n:
            continue
        key = (rows, h, dtype, res)
        kinds, count = out.get(key, ((), 0))
        out[key] = (kinds + (kind,), count + n)
    return {key: (" + ".join(kinds), n) for key, (kinds, n) in out.items()}


def ln_task_forward(task, cfg) -> dict:
    """``ln_forward`` of one training forward of a flagship task: its batch
    in the model's layout (x4 for retrieval, x2 images for nlvr), text with
    the task token, and its head: the VL classifiers' LayerNorm at
    2 x bi_hidden, or for VL-binary the pretraining heads' two transforms
    (which its forward computes) and its classifier's."""
    t, r = task_geometry(task, cfg)
    b = task.batch_size * {"retrieval": 4, "nlvr": 2}.get(task.process, 1)
    wide = 2 * cfg.bi_hidden_size
    heads = {"VL-classifier": [("classifier", b, wide)],
             "VL-classifier-GQA": [("classifier", b, wide)],
             "VL-binary-classifier": [("LM transform", b * t, cfg.hidden_size),
                                      ("image transform", b * r, cfg.v_hidden_size),
                                      ("classifier", b // 2, wide)]}.get(task.type, ())
    return ln_forward(cfg, b, t, r, heads)


#: the paths whose K4 shapes phase 5 times: a VQA forward at B=1024, a CC
#: step, one multi-task iteration (a step of each flagship task)
LN_PATHS = ("vqa", "cc", "multitask")


def ln_shapes() -> dict:
    """K4's distinct shapes on the three paths, {(rows, H, dtype name,
    residual): {"label": ..., "vqa": n, "cc": n, "multitask": n}}, with
    each path's launches: a VQA forward (B=1024, T=23, R=101, the VQA head),
    a CC step (B=256, T=36, R=37; the LM transform on LM_GATHER tokens a
    sample, the image transform on every region) and one multi-task
    iteration. Phases 5, 6 and 8 check these against recordings."""
    from vilbert_tpu_torch.core.config import ModelConfig

    cfg = ModelConfig.from_json_file(CONFIG)
    wide = 2 * cfg.bi_hidden_size
    per_path = {
        "vqa": [("VQA", ln_forward(cfg, TIME_BATCH, T, R,
                                   [("classifier", TIME_BATCH, wide)]))],
        "cc": [("CC", ln_forward(cfg, TRAIN_BATCH, TRAIN_T, TRAIN_R,
                                 [("LM transform", TRAIN_BATCH * LM_GATHER, cfg.hidden_size),
                                  ("image transform", TRAIN_BATCH * TRAIN_R,
                                   cfg.v_hidden_size)]))],
        "multitask": [(key, ln_task_forward(task, cfg.replace(task_specific_tokens=True)))
                      for key, task in flagship_tasks().items()],
    }
    out = {}
    for path, sources in per_path.items():
        for who, shapes in sources:
            for key, (kind, n) in shapes.items():
                row = out.setdefault(key, {"who": {}, **{p: 0 for p in LN_PATHS}})
                row["who"].setdefault(kind, []).append(who)
                row[path] += n
    for row in out.values():
        row["label"] = "; ".join(f"{','.join(who)} {kind}" for kind, who in row.pop("who").items())
    return out


def time_layer_norm(checks: Checks, shapes: dict, card: str, err: dict, g, *,
                    paths=LN_PATHS, wdtype=None) -> dict:
    """K4 at each of ``shapes`` (``ln_shapes()``'s form, launches under
    ``paths``): the routed kernel against its plain version (output within
    phase 3's bounds), every variant named, ``F.layer_norm(x + residual)``
    (the add inside the timed call) and the bound (bytes: inputs and the
    output once, weight and bias once). Weight and bias in ``wdtype``
    (fp32 by default; bf16 times the bf16-weight instantiation, under
    ``("layer_norm_bf16_weight", label)``)."""
    import torch
    import torch.nn.functional as F

    from vilbert_tpu_torch.ops.layernorm import (
        VARIANTS,
        layer_norm,
        layer_norm_kernel,
        layer_norm_ref,
        ln_variant,
    )

    wdtype = wdtype or torch.float32
    name = "layer_norm" if wdtype == torch.float32 else "layer_norm_bf16_weight"
    err_key = {"layer_norm": "layer_norm_fwd"}.get(name, "layer_norm_fwd_bf16_weight")
    times = {}
    for (rows, h, dtype_name, with_res), info in shapes.items():
        dtype = getattr(torch, dtype_name)
        xx = torch.randn(rows, h, generator=g, device=DEVICE).to(dtype)
        res = torch.randn(rows, h, generator=g, device=DEVICE).to(dtype) if with_res else None
        w = (1 + 0.1 * torch.randn(h, generator=g, device=DEVICE)).to(wdtype)
        b = (0.1 * torch.randn(h, generator=g, device=DEVICE)).to(wdtype)
        wl, bl = w.to(dtype), b.to(dtype)
        fns = {"kernel": lambda: layer_norm(xx, w, b, residual=res),
               "plain": lambda: layer_norm_ref(xx, w, b, residual=res),
               "library": lambda: F.layer_norm(xx + res if with_res else xx, (h,), wl, bl,
                                               1e-12),
               **{v: lambda v=v: layer_norm_kernel(xx, w, b, residual=res, variant=v)
                  for v in VARIANTS}}
        variant = ln_variant(rows, h, dtype)
        want = fns["plain"]().float()
        e = float((fns["kernel"]().float() - want).abs().max())
        bound_e = 1e-4 if dtype == torch.float32 else bf16_bound(want)
        err[err_key] = max(err[err_key], e)
        wtext = f" weight {str(wdtype)[6:]}"
        checks.expect(e <= bound_e, f"layer_norm {info['label']} rows={rows} H={h} {dtype_name}"
                                    f"{wtext} residual={with_res} [{variant}]: max|err| {e:.3e} "
                                    f"<= {bound_e:.3e}")
        row = timed_row(fns, "kernel", "plain", xx.element_size() * rows * h
                        * (3 if with_res else 2) + 2 * w.element_size() * h, 8 * rows * h,
                        FP32_FLOPS, library="library")
        row.update(variant=variant, launches_by_path={p: info[p] for p in paths})
        times[(name, info["label"])] = row
        log(f"  layer_norm {info['label']} rows={rows} H={h} residual={with_res} {dtype_name}"
            f"{wtext} [{variant}] (library: F.layer_norm(x{' + residual' if with_res else ''})): "
            f"{row_text(row)}; launches {'/'.join(paths)} "
            f"{'/'.join(str(info[p]) for p in paths)} [{card}]")
    return times


def phase_timing(checks: Checks, model, cfg, card: str, err: dict) -> dict:
    import torch

    import torch.nn.functional as F

    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.ops.attention import attention_kernel

    B = TIME_BATCH
    x = random_batch(cfg, B, SEED + 2)
    shapes = ln_shapes()
    with torch.inference_mode(), recording_ln_shapes() as ln_seen:
        reset_launches()
        model(**x, heads=("vil_prediction",))
        torch.cuda.synchronize()
        launches = read_launches()
    check_ln_recording(checks, f"VQA forward B={B}", ln_seen,
                       {key: row["vqa"] for key, row in shapes.items()}, launches)
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
    for label, heads, d, sq, sk in VQA_ATTENTIONS:
        q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                        for s in (sq, sk, sk, sq))
        bias = ((1.0 - mask[:, :sk].float()) * -10000.0)[:, None, None, :]
        fns, routed = k1_fns(q, k, v, bias, dict(num_heads=heads))
        fns["library"] = library_attention_fns(q, k, v, bias, cot, heads, d)["library"]
        if label == "image self":  # the CUDA-core variant beside the tensor-core ones
            fns["cc"] = lambda: attention_kernel(q, k, v, bias, num_heads=heads, variant="cc")
        check_k1_variants(checks, err, fns, f"attention {label} B={B} bf16")
        row = timed_row(fns, "kernel", "plain", *attention_cost(B, heads, d, sq, sk)["fwd"],
                        BF16_TC_FLOPS, library="library")
        row["variant"] = routed
        times[("attention_fwd", "VQA " + label, 0.0)] = row
        log(f"  attention {label} B={B} h={heads} d={d} {sq}x{sk} bf16 rate 0 [{routed}] "
            f"(library: SDPA): {row_text(row)} [{card}]")
    times.update(time_layer_norm(checks, shapes, card, err, g))
    checks.end_phase("timing")
    return times


# -- phase 6 -----------------------------------------------------------------

def kernel_calls_per_step(cfg) -> dict:
    """Launches of one pretraining step: K1 and K2 once per attention (text
    and image layers, two directions per connection layer); K4 twice per
    text and image layer, four times per connection layer, at the two
    embeddings and in the two head transforms."""
    n_c = cfg.num_connection_layers
    attn = cfg.num_hidden_layers + cfg.v_num_hidden_layers + 2 * n_c
    ln = 2 * cfg.num_hidden_layers + 2 * cfg.v_num_hidden_layers + 4 * n_c + 2 + 2
    return {"attention": attn, "attention_bwd": attn, "layer_norm": ln}


def bench_batch(cfg, batch: int, seed: int) -> dict:
    """A CC batch from a numpy seed, as bench.py:286-309 builds it."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = {
        "input_ids": rng.randint(1, cfg.vocab_size, (batch, TRAIN_T)).astype(np.int32),
        "image_feat": rng.randn(batch, TRAIN_R, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(batch, TRAIN_R, 5).astype(np.float32),
        "segment_ids": np.zeros((batch, TRAIN_T), np.int32),
        "input_mask": np.ones((batch, TRAIN_T), np.int32),
        "image_mask": np.ones((batch, TRAIN_R), np.int32),
        "lm_label_ids": np.where(rng.rand(batch, TRAIN_T) < 0.15,
                                 rng.randint(0, cfg.vocab_size, (batch, TRAIN_T)),
                                 -1).astype(np.int32),
        "image_label": np.where(rng.rand(batch, TRAIN_R - 1) < 0.15, 1, -1).astype(np.int32),
        "image_target": rng.rand(batch, TRAIN_R - 1, cfg.v_target_size).astype(np.float32),
        "is_next": rng.randint(0, 2, (batch,)).astype(np.int32),
    }
    out["image_target"] /= out["image_target"].sum(-1, keepdims=True)
    return out


def phase_train(checks: Checks) -> tuple:
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, train
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator, use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

    args = build_parser().parse_args([
        "--synthetic", "--config", CONFIG, "--batch_size", str(TRAIN_BATCH),
        "--num_steps", str(TRAIN_STEPS), "--seed", str(SEED), "--device", DEVICE,
    ])
    losses = []
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        state = train(args, hooks=[lambda step, st, m: losses.append(
            {k: float(v) for k, v in m.items()})])
        torch.cuda.synchronize()
        launches = read_launches()
    model = state.model
    cfg = model.cfg
    log(f"  train {CONFIG}: {sum(p.numel() for p in model.parameters())} params, "
        f"{cfg.compute_dtype}, B={TRAIN_BATCH} T={args.seq_len} R={args.region_len + 1}, "
        f"dropout {cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, "
        f"{TRAIN_STEPS} steps in {time.time() - t0:.1f} s (set-up and host loader included); "
        f"launches {launches}")
    for i, m in enumerate(losses):
        log(f"  step {i + 1}: loss {m['loss']:.6f} (t {m['masked_loss_t']:.4f} "
            f"v {m['masked_loss_v']:.4f} nsp {m['next_sentence_loss']:.4f}) "
            f"grad_norm {m['grad_norm']:.4f}")
    checks.expect(cfg.compute_dtype == "bfloat16" and min(
        cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob, cfg.v_hidden_dropout_prob,
        cfg.v_attention_probs_dropout_prob) == 0.1, "bf16 compute, dropout 0.1 at every site")
    checks.expect(len(losses) == TRAIN_STEPS and all(
        math.isfinite(v) for m in losses for v in m.values()), "losses and grad norms finite")
    for name, per_step in kernel_calls_per_step(cfg).items():
        checks.expect(launches[name] == TRAIN_STEPS * per_step,
                      f"{name} launches {launches[name]} == {TRAIN_STEPS} x {per_step}")
    # bf16: K1 as fwd_variant routes the step's shapes, K2 on "tc"
    check_k1(checks, f"{TRAIN_STEPS} CC steps", launches,
             k1_routed(vl_attention_shapes(cfg, TRAIN_T, TRAIN_R), TRAIN_STEPS), no_k2=False)
    checks.expect(launches["attention_bwd_tc"] == launches["attention_bwd"]
                  and launches["attention_bwd_cc"] == 0,
                  f"attention_bwd tensor-core launches {launches['attention_bwd_tc']} == "
                  f"{launches['attention_bwd']}, CUDA-core {launches['attention_bwd_cc']} == 0")
    check_ln_recording(checks, f"{TRAIN_STEPS} CC steps", ln_seen,
                       {key: row["cc"] for key, row in ln_shapes().items()}, launches,
                       TRAIN_STEPS)

    # one fp32 step with dropout on, through the kernels and the plain ops
    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = ViLBERTForPretraining(cfg32)
    m32.load_state_dict(model.state_dict())
    m32 = m32.to(DEVICE)
    batch = to_device(host_batch(bench_batch(cfg32, TRAIN_CHECK_BATCH, SEED + 5), cfg32), DEVICE)
    loss_fn = make_pretrain_loss_fn(cfg32, lm_gather=LM_GATHER)
    result = {}
    for plain in (False, True):
        use_plain_ops(m32, plain)
        set_dropout_generator(m32, torch.Generator().manual_seed(SEED + 7))  # same masks
        m32.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m32, batch)
        loss.backward()
        result[plain] = (loss.item(), {n: p.grad.clone() for n, p in m32.named_parameters()})
    (lk, gk), (lp, gp) = result[False], result[True]
    loss_err = abs(lk - lp) / abs(lp)
    # each gradient within 1e-3 of its own max|grad| plus 1e-6 of the largest
    # gradient of the model: fp32 products summed in another order through 30
    # attentions and 64 LayerNorms forward and backward, with the same dropout
    # masks; the floor covers gradients that are zero but for rounding (the
    # key biases': softmax is shift-invariant)
    top = max(float(g.abs().max()) for g in gp.values())
    worst = max(float((gk[n] - gp[n]).abs().max())
                / (1e-3 * float(gp[n].abs().max()) + 1e-6 * top) for n in gp)
    checks.expect(math.isfinite(lk) and loss_err <= 1e-5 and worst <= 1.0,
                  f"B={TRAIN_CHECK_BATCH} fp32 step with dropout, kernels vs plain ops: loss "
                  f"{lk:.6f} vs {lp:.6f} (rel {loss_err:.3e} <= 1e-5), worst gradient at "
                  f"{worst:.3e} of its bound (<= 1)")
    del m32, result, gk, gp
    checks.end_phase("train")
    return state, args, launches


# -- phase 7 -----------------------------------------------------------------

def phase_train_timing(checks: Checks, state, args, card: str, err: dict) -> dict:
    import torch

    from vilbert_tpu_torch.cli.train_concap import optimizer_config
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator, use_plain_ops
    from vilbert_tpu_torch.ops.attention import (
        attention,
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_kernel,
        attention_ref,
    )
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

    model, cfg = state.model, state.model.cfg
    del state  # frees the run's Adam moments
    opt, _ = build_optimizer(optimizer_config(args, schedule="constant"),
                             dict(model.named_parameters()), 1000)
    step = make_train_step(make_pretrain_loss_fn(cfg, lm_gather=LM_GATHER), opt)
    batch = to_device(host_batch(bench_batch(cfg, TRAIN_BATCH, SEED + 6), cfg), DEVICE)
    set_dropout_generator(model, torch.Generator().manual_seed(SEED))
    warmup, timed = 2, 6
    times = {}
    for plain in (True, False, False, True):
        use_plain_ops(model, plain)
        for _ in range(warmup):
            step(model, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            metrics = step(model, batch)
        loss = float(metrics["loss"])  # ends the timed steps
        dt = time.perf_counter() - t0
        label = "plain ops" if plain else "kernels"
        times.setdefault(("train", label), []).append(TRAIN_BATCH * timed / dt)
        log(f"  train step B={TRAIN_BATCH} T={TRAIN_T} R={TRAIN_R} bf16 {label}: "
            f"{dt / timed * 1e3:.2f} ms/step = {TRAIN_BATCH * timed / dt:.1f} samples/s "
            f"(loss {loss:.4f}) [{card}]")
    use_plain_ops(model, False)
    del model, opt, batch

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    B = TRAIN_BATCH
    bias = torch.zeros(B, 1, 1, TRAIN_R, device=DEVICE)
    for label, heads, d, sq, sk in CC_ATTENTIONS:
        q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                        for s in (sq, sk, sk, sq))
        b = bias[..., :sk]
        cost = attention_cost(B, heads, d, sq, sk)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            with torch.inference_mode():
                e, bnd, ok = _fwd_error(attention(q, k, v, b, **kw),
                                        attention_ref(q, k, v, b, **kw), "bfloat16")
                eb, okb = _bwd_errors(attention_bwd(q, k, v, b, cot, **kw),
                                      attention_bwd_ref(q, k, v, b, cot, **kw), "bfloat16")
            err["attention_fwd"] = max(err["attention_fwd"], e)
            err["attention_bwd"] = max(err["attention_bwd"], eb)
            checks.expect(ok and okb, f"CC attention {label} B={B} bf16 rate "
                                      f"{rate}: fwd max|err| {e:.3e} (<= {bnd:.3e}), "
                                      f"bwd max|err| {eb:.3e}")
            fwd, routed = k1_fns(q, k, v, b, kw)
            bwd = bwd_fns(q, k, v, b, cot, kw)
            lib = library_attention_fns(q, k, v, b, cot, heads, d) if rate == 0.0 else {}
            if label == "image self":  # the CUDA-core variants beside the tensor-core ones
                fwd["cc"] = lambda: attention_kernel(q, k, v, b, variant="cc", **kw)
                bwd["cc"] = lambda: attention_bwd_kernel(q, k, v, b, cot, variant="cc", **kw)
            check_k1_variants(checks, err, fwd, f"CC attention {label} B={B} bf16 rate {rate}")
            with torch.inference_mode():
                fwd_lib = {"library": lib["library"]} if lib else {}
                rows = {"fwd": timed_row({**fwd, **fwd_lib}, "kernel", "plain", *cost["fwd"],
                                         BF16_TC_FLOPS, library="library" if lib else None)}
            rows["bwd"] = timed_row(
                {**bwd, **lib}, "kernel", "plain", *cost["bwd"], BF16_TC_FLOPS,
                library=(lambda dev: dev["library_fwd_bwd"] - dev["library"]) if lib else None)
            rows["fwd"]["variant"] = routed
            for kind, row in rows.items():
                times[(f"attention_{kind}", "CC " + label, rate)] = row
                log(f"  CC attention {kind} {label} B={B} h={heads} d={d} {sq}x{sk} bf16 rate "
                    f"{rate}: {row_text(row)} [{card}]")
    # the tensor-core kernels' tiling edges at the step's batch
    for heads, d, sq, sk in TILE_EDGE_CASES:
        q, k, v, cot, eb_bias = _attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            with torch.inference_mode():
                e, bnd, ok = _fwd_error(attention(q, k, v, eb_bias, **kw),
                                        attention_ref(q, k, v, eb_bias, **kw), "bfloat16")
                eb, okb = _bwd_errors(attention_bwd(q, k, v, eb_bias, cot, **kw),
                                      attention_bwd_ref(q, k, v, eb_bias, cot, **kw), "bfloat16")
            err["attention_fwd"] = max(err["attention_fwd"], e)
            err["attention_bwd"] = max(err["attention_bwd"], eb)
            checks.expect(ok and okb, f"attention h={heads} d={d} Sq={sq} Sk={sk} B={B} bf16 "
                                      f"rate {rate}: fwd max|err| {e:.3e} (<= {bnd:.3e}), "
                                      f"bwd max|err| {eb:.3e}")
    checks.end_phase("train timing")
    return times


# -- phase 8 -----------------------------------------------------------------

MT_ITERATIONS = 2
MT_CHECK_BATCH = 2  # fp32 iteration, kernels vs plain ops, samples a task
MT_LOADER_LEN = 64  # batches a synthetic loader reports (the epoch length)
#: the heads of ViLBERTForVLTasks by parameter prefix, and the one each task
#: type trains
HEAD_PREFIXES = ("vil_prediction.", "vil_prediction_gqa.", "vil_logit.",
                 "vil_binary_prediction.", "vil_tri_prediction.", "vision_logit.",
                 "linguisic_logit.", "cls.")


class SyntheticLoader:
    """One batch, yielded ``n`` times an epoch (the pattern of bench.py:414-423)."""

    def __init__(self, batch: dict, n: int):
        self.batch, self.n = batch, n
        self.batch_size = len(batch["target"])

    def __iter__(self):
        return iter([self.batch] * self.n)

    def __len__(self):
        return self.n


def task_batch(task, B: int, vocab: int, seed: int) -> dict:
    """A numpy batch at the task's text length and region count, in its
    process mode's layout: [B, 4, ...] for retrieval, [B, 2R, ...] images
    for nlvr, ``multiple_choice_ids`` and per-option targets for the
    V-logit-mc tasks (4 options for Visual7w, 204 for GuessWhatPointing);
    padded tokens and regions, 2048-d features."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T_, R_ = task.max_seq_length, task.max_region_num
    lead = (B, 4) if task.process == "retrieval" else (B,)
    rows = 2 * R_ if task.process == "nlvr" else R_

    def lengths(n, lo):
        # every row of a V-logit-mc image is a candidate: no padded region
        if n == R_ and task.type == "V-logit-mc":
            return np.full(lead, n)
        return rng.integers(lo, n + 1, lead)

    t_len, r_len = lengths(T_, 3), lengths(rows, rows // 2)
    b = {
        "question": rng.integers(1, vocab, lead + (T_,)).astype(np.int32),
        "input_mask": (np.arange(T_) < t_len[..., None]).astype(np.int32),
        "segment_ids": np.zeros(lead + (T_,), np.int32),
        "features": rng.standard_normal(lead + (rows, 2048), dtype=np.float32),
        "spatials": rng.random(lead + (rows, 5), dtype=np.float32),
        "image_mask": (np.arange(rows) < r_len[..., None]).astype(np.int32),
    }
    if task.type in ("VL-classifier", "VL-classifier-GQA"):
        n = 3129 if task.type == "VL-classifier" else 1533
        t = np.zeros((B, n), np.float32)
        t[np.arange(B)[:, None], rng.integers(0, n, (B, 3))] = rng.choice([0.3, 0.6, 1.0], (B, 3))
        b["target"] = t
    elif task.type == "V-logit":
        # a region matches the expression where it is a valid box (not the
        # global row, not padding), as the datasets' IoU targets
        hit = (rng.random((B, R_)) < 0.05) & (b["image_mask"] == 1)
        hit[:, 0] = False
        b["target"] = hit[..., None].astype(np.float32)
    elif task.type == "V-logit-mc":
        n_opt = 204 if task.name == "GuessWhatPointing" else 4
        b["multiple_choice_ids"] = rng.integers(0, R_ - 101, (B, n_opt)).astype(np.int64)
        b["target"] = (rng.random((B, n_opt, 1)) < 0.25).astype(np.float32)
    elif task.process == "retrieval":
        b["target"] = np.zeros((B,), np.int64)  # the true pair is option 0
    else:
        n = 3 if task.type == "VL-tri-classifier" else 2
        b["target"] = rng.integers(0, n, (B,)).astype(np.int64)
    return b


def multitask_loaders(tasks: dict, vocab: int, batch: int = 0, n: int = MT_LOADER_LEN):
    """Train and val loaders of one synthetic batch a task, at each task's
    batch size (or ``batch``)."""
    train, val = {}, {}
    for i, (key, task) in enumerate(tasks.items()):
        b = task_batch(task, batch or task.batch_size, vocab, SEED + 100 + i)
        train[key], val[key] = SyntheticLoader(b, n), SyntheticLoader(b, 1)
    return train, val


def task_geometry(task, cfg) -> tuple:
    """(text length with the task token, regions) the encoder sees."""
    return task.max_seq_length + int(cfg.task_specific_tokens), task.max_region_num


#: the counters of the elementwise kernels, whose launches follow each
#: task's heads and which sites its loss reaches
ELEMENTWISE_COUNTERS = ("gelu_rational", "hash_dropout")


def check_elementwise_launches(checks: Checks, what: str, launches: dict) -> None:
    """The gelu's and the dropout's kernels launched forward, and backward
    no more often than forward (a backward runs where the loss reaches)."""
    for name in ELEMENTWISE_COUNTERS:
        fwd, bwd = launches[name], launches[f"{name}_bwd"]
        checks.expect(fwd > 0 and 0 < bwd <= fwd,
                      f"{what}: {name} launches forward {fwd} > 0, backward {bwd} in (0, {fwd}]")


def multitask_launches(tasks: dict, cfg, steps: int, evals: int) -> dict:
    """Launch counts of ``steps`` training steps and ``evals`` eval forwards
    of every task: K1 30 a forward (text self x12, image self x6, both
    co-attention directions x6), on the variant ``fwd_variant`` picks
    (bf16: none on the CUDA cores); K2 once for each attention the
    loss reaches, on the variant ``bwd_variant`` picks ("wg" past 128 keys
    and for text->image at d = 128, "tc" else): 30 a step, 28 for the V-logit
    types, whose loss reads the image stream only (the text layers after
    the last co-attention and its text-query direction feed no image
    output); K4 as ``ln_task_forward`` says (its variants:
    ``check_ln_recording``). The elementwise kernels' counters (the gelu's,
    the dropout's) are left out: ``check_elementwise_launches`` reads them."""
    import torch

    from vilbert_tpu_torch.ops.attention import bwd_variant

    n_t, n_v = cfg.num_hidden_layers, cfg.v_num_hidden_layers
    n_c = cfg.num_connection_layers
    d_t = cfg.hidden_size // cfg.num_attention_heads
    d_v = cfg.v_hidden_size // cfg.v_num_attention_heads
    d_c = cfg.bi_hidden_size // cfg.bi_num_attention_heads
    schedule = cfg.encoder_schedule()
    last_c = max(i for i, (kind, _) in enumerate(schedule) if kind == "c")
    trailing_t = sum(kind == "t" for kind, _ in schedule[last_c + 1:])
    out = {name: 0 for name in _counters()
           if not name.startswith(("layer_norm_",) + ELEMENTWISE_COUNTERS)}
    for task in tasks.values():
        t, r = task_geometry(task, cfg)
        # (Sq, Sk, head width) of each attention
        tt, rr, tr, rt = (t, t, d_t), (r, r, d_v), (t, r, d_c), (r, t, d_c)
        shapes = [tt] * n_t + [rr] * n_v + [tr, rt] * n_c
        bwd = shapes
        if task.type in ("V-logit", "V-logit-mc"):
            bwd = [tt] * (n_t - trailing_t) + [rr] * n_v + [tr, rt] * (n_c - 1) + [rt]
        fwd = steps + evals
        for name, n in k1_routed(shapes, fwd).items():
            out[name] += n
        out["attention_bwd"] += steps * len(bwd)
        for sq, sk, d in bwd:
            out[f"attention_bwd_{bwd_variant(torch.bfloat16, sq, sk, d)}"] += steps
        out["layer_norm"] += fwd * sum(n for _, n in ln_task_forward(task, cfg).values())
    return out


def multitask_args(output_dir: str, extra=()):
    from vilbert_tpu_torch.cli.train_tasks import build_parser

    return build_parser().parse_args([
        "--config", CONFIG, "--task_specific_tokens", "--lr_scheduler", "mannul",
        "--head_lr", "1e-4", "--seed", str(SEED), "--device", DEVICE,
        "--output_dir", output_dir, *extra,
    ])


def phase_multitask(checks: Checks, tmp: str) -> tuple:
    import torch

    from vilbert_tpu_torch.cli.train_tasks import train
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.train.multitask import HEAD_FOR_TYPE

    tasks = flagship_tasks()
    cfg = ModelConfig.from_json_file(CONFIG, task_specific_tokens=True)
    t0 = time.time()
    loaders, val_loaders = multitask_loaders(tasks, cfg.vocab_size)
    log(f"  synthetic batches of {len(tasks)} tasks built in {time.time() - t0:.1f} s: "
        + ", ".join(f"{k} B={t.batch_size} T={task_geometry(t, cfg)[0]} "
                    f"R={task_geometry(t, cfg)[1]} {t.process}" for k, t in tasks.items()))
    heads_before, head_checks, losses = {}, [], []

    def head_hook(key, model, metrics):
        params = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n.startswith(HEAD_PREFIXES)}
        if metrics is None:
            heads_before.clear()
            heads_before.update(params)
            return
        losses.append((key, float(metrics["loss"]), float(metrics["score"])))
        own = HEAD_FOR_TYPE[tasks[key].type] + "."
        others = all(torch.equal(p, heads_before[n]) for n, p in params.items()
                     if not n.startswith(own))
        moved = any(not torch.equal(p, heads_before[n]) for n, p in params.items()
                    if n.startswith(own))
        head_checks.append((key, others, moved))

    args = multitask_args(tmp, ["--num_iterations", str(MT_ITERATIONS)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        trainer = train(args, tasks, loaders, val_loaders=val_loaders, task_hooks=[head_hook])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        evals = {key: trainer.evaluate(key, max_batches=1) for key in tasks}
        torch.cuda.synchronize()
        launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = trainer.model_cfg
    log(f"  train {CONFIG}: {sum(p.numel() for p in trainer.model.parameters())} params, "
        f"{cfg.compute_dtype}, task tokens {cfg.task_specific_tokens}, dropout "
        f"{cfg.hidden_dropout_prob}/{cfg.attention_probs_dropout_prob}, {MT_ITERATIONS} "
        f"iterations of {len(tasks)} tasks in {train_s:.1f} s (set-up, first calls and host "
        f"loader included), peak memory {peak_gb:.2f} GB; launches {launches}")
    for key, loss, score in losses:
        log(f"  step {key}: loss {loss:.6f} score {score:.4f}")
    for key, r in evals.items():
        log(f"  evaluate {key}: loss {r['loss']:.6f} score {r['score']:.4f}")
    checks.expect(cfg.compute_dtype == "bfloat16" and cfg.task_specific_tokens and min(
        cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob, cfg.v_hidden_dropout_prob,
        cfg.v_attention_probs_dropout_prob) == 0.1 and trainer.opt_cfg.schedule == "mannul"
        and not trainer.opt_cfg.correct_bias and trainer.opt_cfg.head_lr == 1e-4,
        "bf16, task tokens, dropout 0.1 at every site, mannul, no bias correction, head lr 1e-4")
    checks.expect(len(losses) == MT_ITERATIONS * len(tasks) and all(
        math.isfinite(v) for _, loss, score in losses for v in (loss, score)) and all(
        math.isfinite(r["loss"]) for r in evals.values()),
        f"{len(losses)} task steps and {len(evals)} evaluations, every loss finite")
    checks.expect(len(head_checks) == len(losses) and all(o for _, o, _ in head_checks),
                  "after each task's step every other head (cls included) is bitwise unchanged")
    checks.expect(all(m for _, _, m in head_checks), "each task's step moves its own head")
    want = multitask_launches(tasks, cfg, MT_ITERATIONS, 1)
    for name, n in want.items():
        checks.expect(launches[name] == n, f"{name} launches {launches[name]} == {n}")
    check_elementwise_launches(checks, f"{MT_ITERATIONS} iterations", launches)
    log("  K4 shapes recorded (rows, H, dtype, residual): launches: " + ", ".join(
        f"{k}: {n}" for k, n in sorted(ln_seen.items())))
    check_ln_recording(checks, f"{MT_ITERATIONS} iterations and an evaluation of each task",
                       ln_seen, {key: row["multitask"] for key, row in ln_shapes().items()},
                       launches, MT_ITERATIONS + 1)
    checks.end_phase("multi-task slice")

    # one fp32 iteration with dropout, kernels vs plain ops, full geometry
    t0 = time.time()
    reset_launches()
    result = multitask_fp32_steps(trainer, tasks)
    torch.cuda.synchronize()
    fp32_launches = read_launches()
    log("  fp32 steps (kernels / plain loss, worst gradient at its bound): " + ", ".join(
        f"{k} {lk:.6f}/{lp:.6f} {w:.2e}" for k, (lk, lp, w) in result.items())
        + f" in {time.time() - t0:.1f} s; launches {fp32_launches}")
    checks.expect(fp32_launches["attention_cc"] == fp32_launches["attention"] > 0,
                  f"fp32 K1 launches {fp32_launches['attention']} all on the CUDA-core variant "
                  f"({fp32_launches['attention_cc']})")
    loss_err = max(abs(lk - lp) / max(abs(lp), 1e-30) for lk, lp, _ in result.values())
    worst = max(w for _, _, w in result.values())
    checks.expect(len(result) == len(tasks) and all(
        math.isfinite(lk) for lk, _, _ in result.values()) and loss_err <= 1e-5 and worst <= 1.0,
        f"B={MT_CHECK_BATCH} a task fp32 iteration with dropout, kernels vs plain ops: worst "
        f"loss rel {loss_err:.3e} (<= 1e-5), worst gradient at {worst:.3e} of its bound (<= 1)")
    checks.end_phase("multi-task fp32 check")
    return trainer, launches, fp32_launches, peak_gb, losses


def multitask_fp32_steps(trainer, tasks) -> dict:
    """One round-robin iteration of an fp32 copy of ``trainer``'s model at
    MT_CHECK_BATCH samples a task, through the kernels, with a copy through
    the plain ops in lockstep: before each task's step the plain model takes
    the kernel model's weights, both draw the same dropout seeds. Returns
    {task: (kernel loss, plain loss, worst gradient over its bound)}, the
    bound of phase 6: 1e-3 of the tensor's max|grad| plus 1e-6 of the
    model's."""
    import numpy as np
    import torch

    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    cfg32 = trainer.model_cfg.replace(compute_dtype="float32")
    state = {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}
    loaders, _ = multitask_loaders(tasks, cfg32.vocab_size, MT_CHECK_BATCH, n=1)
    runs = []
    for plain in (False, True):
        model = ViLBERTForVLTasks(cfg32)
        model.load_state_dict(state)
        runs.append(MultiTaskTrainer(cfg32, tasks, loaders, opt_cfg=trainer.opt_cfg,
                                     init_model=use_plain_ops(model, plain), seed=SEED + 9,
                                     device=DEVICE))
    kern, plain = runs
    pk, pp = dict(kern.model.named_parameters()), dict(plain.model.named_parameters())
    lr_first = float(np.float32(kern.schedule(0)))
    lr_rest = float(np.float32(kern.schedule.mid_iteration(0)))
    out = {}
    for i, key in enumerate(tasks):
        with torch.no_grad():
            for n, p in pp.items():
                p.copy_(pk[n])
        lr = lr_first if i == 0 else lr_rest
        losses = [float(t.tasks[key].step_fn(t.model, t.tasks[key].next_batch(), lr)["loss"])
                  for t in (kern, plain)]
        gk = {n: p.grad for n, p in pk.items() if p.grad is not None}
        gp = {n: p.grad for n, p in pp.items() if p.grad is not None}
        if set(gk) != set(gp):
            raise SystemExit(f"chip_smoke: {key}: the two paths' gradients cover different "
                             f"parameters: {sorted(set(gk) ^ set(gp))[:5]}")
        top = max(float(g.abs().max()) for g in gp.values())
        worst = max(float((gk[n] - gp[n]).abs().max())
                    / (1e-3 * float(gp[n].abs().max()) + 1e-6 * top) for n in gp)
        out[key] = (*losses, worst)
    del kern, plain, runs, pk, pp
    return out


# -- phase 9 -----------------------------------------------------------------

#: (label, heads, head_dim, Sq, Sk, B) of the long attentions of Visual7w
#: (B=256, 20+1 tokens, 200 regions) and GuessWhatPointing (B=64, 256+1
#: tokens, 306 regions)
MT_ATTENTIONS = (
    ("Visual7w image self", 8, 128, 200, 200, 256),
    ("Visual7w text->image", 8, 128, 21, 200, 256),
    ("Visual7w image->text", 8, 128, 200, 21, 256),
    ("GuessWhatPointing text self", 12, 64, 257, 257, 64),
    ("GuessWhatPointing image self", 8, 128, 306, 306, 64),
    ("GuessWhatPointing text->image", 8, 128, 257, 306, 64),
    ("GuessWhatPointing image->text", 8, 128, 306, 257, 64),
)


def phase_multitask_timing(checks: Checks, trainer, card: str, err: dict) -> dict:
    import torch

    from vilbert_tpu_torch.ops.attention import (
        TC_MAX_SEQ,
        attention,
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_kernel,
        attention_ref,
        bwd_variant,
        fwd_variant,
    )

    # each task's step, one batch held on the card
    step_times, total_ms, total_samples = time_task_steps(trainer, card)
    times = {("multitask_step", key): row for key, row in step_times.items()}
    log(f"  steps of the twelve tasks: {total_ms:.1f} ms = {total_samples / total_ms * 1e3:.1f} "
        f"samples/s, batches on the card [{card}]")
    # whole iterations through the host loader (pinned copies included)
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_iteration(trainer.global_step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times[("multitask_iteration", i)] = {"s": dt, "samples_per_s": total_samples / dt}
        log(f"  iteration {trainer.global_step}: {dt:.3f} s = {total_samples / dt:.1f} "
            f"dataset samples/s, host loader included [{card}]")

    # K1 and K2 at the long shapes: against the plain twins, SDPA, bounds
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    for label, heads, d, sq, sk, B in MT_ATTENTIONS:
        q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                        for s in (sq, sk, sk, sq))
        mask = torch.ones(B, sk, dtype=torch.long, device=DEVICE)
        mask[:, sk - sk // 4:] = 0
        b = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        cost = attention_cost(B, heads, d, sq, sk)
        fv, bv = fwd_variant(torch.bfloat16, sq, sk, d), bwd_variant(torch.bfloat16, sq, sk, d)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            with torch.inference_mode():
                want = attention_ref(q, k, v, b, **kw)
                got, on_fv = counted(attention, fv, lambda: attention(q, k, v, b, **kw))
                e, bnd, ok = _fwd_error(got, want, "bfloat16")
                got, on_bv = counted(attention_bwd, bv,
                                     lambda: attention_bwd(q, k, v, b, cot, **kw))
                eb, okb = _bwd_errors(got, attention_bwd_ref(q, k, v, b, cot, **kw), "bfloat16")
                if sk > TC_MAX_SEQ:  # the CUDA-core K1 it replaces, on the same inputs
                    ec, _, okc = _fwd_error(
                        attention_kernel(q, k, v, b, variant="cc", **kw), want, "bfloat16")
                    track_error(err, "attention_fwd", "cc", ec)
                    checks.expect(okc, f"{label} B={B} bf16 rate {rate} [cc, named]: fwd "
                                       f"max|err| {ec:.3e} (<= {bnd:.3e})")
            track_error(err, "attention_fwd", fv, e)
            track_error(err, "attention_bwd", bv, eb)
            checks.expect(ok and okb and on_fv and on_bv,
                          f"{label} B={B} bf16 rate {rate} [{fv}, {bv}]: fwd max|err| {e:.3e} "
                          f"(<= {bnd:.3e}), bwd max|err| {eb:.3e}")
        kw = dict(num_heads=heads)
        lib = library_attention_fns(q, k, v, b, cot, heads, d)
        fwd, _ = k1_fns(q, k, v, b, kw)
        fwd["library"] = lib["library"]
        check_k1_variants(checks, err, fwd, f"{label} B={B} bf16 rate 0")
        if sk > TC_MAX_SEQ:  # the CUDA-core K1 beside the tensor-core ones
            fwd["cc"] = lambda: attention_kernel(q, k, v, b, variant="cc", **kw)
        # the long K2 on the CUDA cores beside the tensor-core ones
        bwd = {**bwd_fns(q, k, v, b, cot, kw),
               "cc": lambda: attention_bwd_kernel(q, k, v, b, cot, variant="long", **kw), **lib}
        with torch.inference_mode():
            rows = {"fwd": timed_row(fwd, "kernel", "plain", *cost["fwd"], BF16_TC_FLOPS,
                                     library="library", iters=5)}
        rows["bwd"] = timed_row(bwd, "kernel", "plain", *cost["bwd"], BF16_TC_FLOPS,
                                library=lambda dev: dev["library_fwd_bwd"] - dev["library"],
                                iters=5)
        rows["fwd"]["variant"], rows["bwd"]["variant"] = fv, bv
        for kind, row in rows.items():
            times[(f"attention_{kind}", label, 0.0)] = row
            log(f"  attention {kind} {label} B={B} h={heads} d={d} {sq}x{sk} bf16 rate 0 "
                f"[{row['variant']}]: {row_text(row)} [{card}]")
    checks.end_phase("multi-task timing")
    return times


# -- phase 10 ----------------------------------------------------------------

#: retrieval at the reference protocol's pool: 1,000 images of 100 boxes (+
#: the global row) in two chunks of 500, captions of 30 tokens
RET_POOL, RET_CHUNK, RET_T, RET_R = 1000, 500, 30, 101
RET_CAPTIONS, RET_ZERO_SHOT_CAPTIONS = 10, 2
RET_CHECK_CAPTIONS = 2  # kernels vs plain ops, fast_mode vs broadcast
#: the demo's geometry (cli/demo.py defaults): one image of 36 boxes + the
#: global row, 30 tokens
DEMO_T, DEMO_R = 30, 37
#: (label, heads, head_dim, Sq, Sk, B) of K1 at the retrieval forward's
#: shapes (the text stream at batch 1 before the first co-attention, with
#: fast_mode) and the demo's (batch 1; its text self-attention is the
#: retrieval's at batch 1)
RET_ATTENTIONS = (
    ("demo and fast retrieval text self", 12, 64, RET_T, RET_T, 1),
    ("retrieval text self", 12, 64, RET_T, RET_T, RET_CHUNK),
    ("retrieval image self", 8, 128, RET_R, RET_R, RET_CHUNK),
    ("retrieval text->image", 8, 128, RET_T, RET_R, RET_CHUNK),
    ("retrieval image->text", 8, 128, RET_R, RET_T, RET_CHUNK),
    ("demo image self", 8, 128, DEMO_R, DEMO_R, 1),
    ("demo text->image", 8, 128, DEMO_T, DEMO_R, 1),
    ("demo image->text", 8, 128, DEMO_R, DEMO_T, 1),
)


def retrieval_args(tmp: str, extra=(), config: str = CONFIG):
    from vilbert_tpu_torch.cli.eval_retrieval import build_parser

    return build_parser().parse_args([
        "--config", config, "--pool_size", str(RET_POOL), "--chunk", str(RET_CHUNK),
        "--max_seq_length", str(RET_T), "--max_region_num", str(RET_R), "--device", DEVICE,
        "--output", os.path.join(tmp, "retrieval.json"), *extra,
    ])


def demo_heads(cfg) -> list:
    """The LayerNorms of the demo's heads at batch 1: the pretraining heads'
    two transforms (every head is computed) and the VQA and GQA
    classifiers'."""
    wide = 2 * cfg.bi_hidden_size
    return [("LM transform", DEMO_T, cfg.hidden_size), ("image transform", DEMO_R, cfg.v_hidden_size),
            ("VQA classifier", 1, wide), ("GQA classifier", 1, wide)]


def retrieval_world():
    """The synthetic pool (no soft targets) and captions: RET_CAPTIONS
    captions of the first images, each of its own image."""
    from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore

    store = InMemoryFeatureStore.synthetic(num_images=RET_POOL, num_boxes=RET_R - 1,
                                           target_dim=None)
    keys = store.keys()
    captions = [(f"a synthetic caption about image {k} number {i}", k)
                for i, k in enumerate(keys[:RET_CAPTIONS])]
    return store, keys, captions


def phase_retrieval(checks: Checks, tmp: str, card: str, err: dict) -> tuple:
    """Retrieval through cli/eval_retrieval.py (fine-tuned with fast_mode,
    then zero-shot) and the demo through cli/demo.py at the flagship width;
    launches, scores against the plain ops and fast_mode against the host
    broadcast at fp32; K1 and K4 timed at the retrieval and demo shapes."""
    import numpy as np
    import torch

    from vilbert_tpu_torch.cli import demo
    from vilbert_tpu_torch.cli.eval_retrieval import load_pool, run
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.tasks import _pad_text
    from vilbert_tpu_torch.data.tokenization import add_special_single, load_tokenizer
    from vilbert_tpu_torch.eval.retrieval import (
        make_alignment_scorer,
        make_vil_logit_scorer,
        score_matrix,
    )
    from vilbert_tpu_torch.models.layers import use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks

    t0 = time.time()
    store, keys, entries = retrieval_world()
    log(f"  synthetic pool of {RET_POOL} images x {RET_R - 1} boxes built in "
        f"{time.time() - t0:.1f} s")
    cfg = ModelConfig.from_json_file(CONFIG, fast_mode=True)
    chunks = RET_POOL // RET_CHUNK
    model = ViLBERTForVLTasks(cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    launches = {}

    # fine-tuned, fast_mode, through the CLI
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        metrics = run(retrieval_args(tmp, ["--fast_mode"]), store=store, keys=keys,
                      caption_entries=entries, model=model)
        torch.cuda.synchronize()
        cli_s = time.time() - t0
        launches["fast"] = read_launches()
    forwards = RET_CAPTIONS * chunks
    log(f"  eval_retrieval --fast_mode: {metrics} in {cli_s:.1f} s (pool load included); "
        f"launches {launches['fast']}")
    checks.expect(metrics["num_captions"] == RET_CAPTIONS and metrics["pool_size"] == RET_POOL
                  and all(math.isfinite(v) for v in metrics.values()),
                  f"{RET_CAPTIONS} captions ranked against {RET_POOL} images, metrics finite")
    check_k1(checks, f"eval_retrieval --fast_mode, {forwards} forwards", launches["fast"],
             k1_routed(vl_attention_shapes(cfg, RET_T, RET_R), forwards))
    fast_shapes = {k: n for k, (_, n) in ln_forward(cfg, RET_CHUNK, RET_T, RET_R,
                                                    fast=True).items()}
    check_ln_recording(checks, "eval_retrieval --fast_mode", ln_seen, fast_shapes,
                       launches["fast"], forwards)

    # zero-shot, through the CLI (the caption broadcast on the host)
    cfg_zs = ModelConfig.from_json_file(CONFIG)
    zs_model = ViLBERTForPretraining(cfg_zs, generator=torch.Generator().manual_seed(SEED))
    zs_model = zs_model.to(DEVICE)
    zs_heads = [("LM transform", RET_CHUNK * RET_T, cfg.hidden_size),
                ("image transform", RET_CHUNK * RET_R, cfg.v_hidden_size)]
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        zs = run(retrieval_args(tmp, ["--zero_shot"]), store=store, keys=keys,
                 caption_entries=entries[:RET_ZERO_SHOT_CAPTIONS], model=zs_model)
        torch.cuda.synchronize()
        zs_s = time.time() - t0
        launches["zero_shot"] = read_launches()
    log(f"  eval_retrieval --zero_shot: {zs} in {zs_s:.1f} s (pool load included); launches "
        f"{launches['zero_shot']}")
    checks.expect(zs["num_captions"] == RET_ZERO_SHOT_CAPTIONS
                  and all(math.isfinite(v) for v in zs.values()), "zero-shot metrics finite")
    zs_forwards = RET_ZERO_SHOT_CAPTIONS * chunks
    check_k1(checks, f"eval_retrieval --zero_shot, {zs_forwards} forwards",
             launches["zero_shot"], k1_routed(vl_attention_shapes(cfg, RET_T, RET_R), zs_forwards))
    zs_shapes = {k: n for k, (_, n) in ln_forward(cfg_zs, RET_CHUNK, RET_T, RET_R,
                                                  zs_heads).items()}
    check_ln_recording(checks, "eval_retrieval --zero_shot", ln_seen, zs_shapes,
                       launches["zero_shot"], zs_forwards)

    # scoring alone: captions/s; kernels against the plain ops (bf16, C6)
    tokenizer = load_tokenizer(None, cfg.vocab_size)
    pool = load_pool(store, keys, RET_R, cfg.v_feature_size)
    index = {k: i for i, k in enumerate(keys)}
    caps = []
    for text, k in entries:
        q, m, sg = _pad_text(add_special_single(
            tokenizer, list(tokenizer.encode(text))[:RET_T - 2]), RET_T)
        caps.append({"question": q, "input_mask": m, "segment_ids": sg,
                     "target_index": index[k]})
    scorer = make_vil_logit_scorer(model)
    rates = {}
    for mode, fn, n, fast in (("fine-tuned fast_mode", scorer, RET_CAPTIONS, True),
                              ("zero-shot", make_alignment_scorer(zs_model),
                               RET_ZERO_SHOT_CAPTIONS, False)):
        score_matrix(fn, caps[:1], pool, chunk=RET_CHUNK, fast_mode=fast, device=DEVICE)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = score_matrix(fn, caps[:n], pool, chunk=RET_CHUNK, fast_mode=fast, device=DEVICE)
        rates[mode] = n / (time.perf_counter() - t0)
        log(f"  {mode} scoring: {n} captions x {RET_POOL} images = {rates[mode]:.3f} captions/s "
            f"(host copies of the pool chunks included) [{card}]")
        if fast:
            kern = scores
    del zs_model
    plain = score_matrix(make_vil_logit_scorer(use_plain_ops(model)), caps[:RET_CHECK_CAPTIONS],
                         pool, chunk=RET_CHUNK, fast_mode=True, device=DEVICE)
    use_plain_ops(model, False)
    scale = max(1.0, float(np.abs(plain).max()))
    e = float(np.abs(kern[:RET_CHECK_CAPTIONS] - plain).max())
    checks.expect(np.isfinite(kern).all() and kern.shape == (RET_CAPTIONS, RET_POOL)
                  and e <= 5e-2 * scale,
                  f"bf16 retrieval scores, kernels vs plain ops: max|err| {e:.3e} <= "
                  f"{5e-2 * scale:.3e} (5e-2 per unit of logit scale)")

    # fp32: fast_mode (text at batch 1) against the caption broadcast on the host
    state = model.state_dict()
    del model, scorer
    scores32 = {}
    for fast in (True, False):
        m32 = ViLBERTForVLTasks(cfg.replace(compute_dtype="float32", fast_mode=fast))
        m32.load_state_dict(state)
        m32 = m32.to(DEVICE)
        scores32[fast] = score_matrix(make_vil_logit_scorer(m32), caps[:RET_CHECK_CAPTIONS],
                                      pool, chunk=RET_CHUNK, fast_mode=fast, device=DEVICE)
        del m32
    e32 = float(np.abs(scores32[True] - scores32[False]).max())
    checks.expect(e32 <= 1e-4, f"fp32 scores, fast_mode vs host broadcast: max|err| {e32:.3e} "
                               f"<= 1e-4 ({RET_CHECK_CAPTIONS} captions x {RET_POOL} images)")
    del state, pool

    # the demo at the flagship config
    buf = io.StringIO()
    with recording_ln_shapes() as ln_seen, contextlib.redirect_stdout(buf):
        reset_launches()
        out = demo.main(["--synthetic", "--config", CONFIG, "--device", DEVICE,
                         "--question", "what color is the couch?"])
        torch.cuda.synchronize()
        launches["demo"] = read_launches()
    log("  demo: " + " | ".join(buf.getvalue().strip().splitlines()))
    checks.expect(all(bool(torch.isfinite(v).all()) for v in out if v is not None)
                  and out.vil_prediction.shape == (1, 3129),
                  "demo: every head finite, 3129 VQA answers")
    check_k1(checks, "demo", launches["demo"], k1_routed(vl_attention_shapes(cfg_zs, DEMO_T,
                                                                             DEMO_R)))
    demo_shapes = {k: n for k, (_, n) in ln_forward(cfg_zs, 1, DEMO_T, DEMO_R,
                                                     demo_heads(cfg_zs)).items()}
    check_ln_recording(checks, "demo", ln_seen, demo_shapes, launches["demo"])
    checks.end_phase("retrieval")

    # K1 and K4 at the retrieval and demo shapes
    times = {}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    for label, heads, d, sq, sk, B in RET_ATTENTIONS:
        q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                        for s in (sq, sk, sk, sq))
        mask = torch.ones(B, sk, dtype=torch.long, device=DEVICE)
        mask[:, sk - sk // 4:] = 0
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        fns, routed = k1_fns(q, k, v, bias, dict(num_heads=heads))
        fns["library"] = library_attention_fns(q, k, v, bias, cot, heads, d)["library"]
        check_k1_variants(checks, err, fns, f"attention {label} B={B} bf16")
        with torch.inference_mode():
            row = timed_row(fns, "kernel", "plain", *attention_cost(B, heads, d, sq, sk)["fwd"],
                            BF16_TC_FLOPS, library="library")
        row["variant"] = routed
        times[("attention_fwd", label, 0.0)] = row
        log(f"  attention {label} B={B} h={heads} d={d} {sq}x{sk} bf16 (library: SDPA): "
            f"{row_text(row)} [{card}]")
    ln_rows = {}
    for path, shapes in (("retrieval", ln_forward(cfg, RET_CHUNK, RET_T, RET_R, fast=True)),
                         ("demo", ln_forward(cfg_zs, 1, DEMO_T, DEMO_R, demo_heads(cfg_zs)))):
        for key, (kind, n) in shapes.items():
            row = ln_rows.setdefault(key, {"labels": [], "retrieval": 0, "demo": 0})
            row["labels"].append(f"{path} {kind}")
            row[path] += n
    ln_rows = {key: {"label": "; ".join(row.pop("labels")), **row} for key, row in ln_rows.items()}
    times.update(time_layer_norm(checks, ln_rows, card, err, g, paths=("retrieval", "demo")))
    checks.end_phase("retrieval timing")
    ret = {"fast": launches["fast"], "zero_shot": launches["zero_shot"], "demo": launches["demo"],
           "captions_per_s": rates}
    return times, ret


# -- phase 11 ----------------------------------------------------------------

BF16_GRAD_STEPS = 2
RESUME_BATCH = 32  # the fp32 resume check


def bf16_grad_shapes(shapes: dict) -> dict:
    """K4's shapes under bf16 gradients: the text embedding's LayerNorm takes
    its sum in the bf16 tables' dtype, so its fp32 shapes become bf16."""
    out = collections.Counter()
    for (rows, h, dtype, res), n in shapes.items():
        out[(rows, h, "bfloat16", res)] += n
    return dict(out)


class _Interrupt(Exception):
    """Ends a run after a checkpoint (phase 11's resume check)."""


def phase_training_options(checks: Checks, trainer, tmp: str, card: str, err: dict) -> tuple:
    """The CC step with bf16 gradients and moments, a multi-task iteration
    with RAdam, the CC resume check and the flagship trainer's
    checkpoint round trip."""
    import torch

    from vilbert_tpu_torch.cli import train_concap, train_tasks
    from vilbert_tpu_torch.core.checkpoint import CheckpointManager
    from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator, use_plain_ops
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining
    from vilbert_tpu_torch.parallel.train_step import bf16_grads, train_state_dict
    from vilbert_tpu_torch.train.pretrain import (
        host_batch,
        make_pretrain_loss_fn,
        run_pretraining,
    )

    # 1. the CC step with --bf16_grads --bf16_adam_state, through the CLI
    args = train_concap.build_parser().parse_args([
        "--synthetic", "--config", CONFIG, "--batch_size", str(TRAIN_BATCH),
        "--num_steps", str(BF16_GRAD_STEPS), "--seed", str(SEED), "--device", DEVICE,
        "--bf16_grads", "--bf16_adam_state", "--output_dir", os.path.join(tmp, "cc_bf16"),
    ])
    losses = []
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        state = train_concap.train(args, hooks=[lambda step, st, m: losses.append(
            {k: float(v) for k, v in m.items()})])
        torch.cuda.synchronize()
        bf16_launches = read_launches()
    opt = state.optimizer
    log(f"  train --bf16_grads --bf16_adam_state: "
        + "; ".join(f"loss {m['loss']:.6f} grad_norm {m['grad_norm']:.4f}" for m in losses)
        + f"; launches {bf16_launches}")
    checks.expect(len(losses) == BF16_GRAD_STEPS and all(
        math.isfinite(v) for m in losses for v in m.values()), "losses and grad norms finite")
    checks.expect({t.dtype for t in (*opt.state.mu.values(), *opt.state.nu.values())}
                  == {torch.bfloat16} and opt.state.count == BF16_GRAD_STEPS
                  and all(p.dtype == torch.float32 for p in opt.params.values()),
                  "moments stored in bf16, parameters fp32, count == steps")
    per_step = kernel_calls_per_step(state.model.cfg)
    checks.expect(bf16_launches["layer_norm_bf16_weight"] == bf16_launches["layer_norm"]
                  == BF16_GRAD_STEPS * per_step["layer_norm"],
                  f"every K4 launch on the bf16-weight instantiation: "
                  f"{bf16_launches['layer_norm_bf16_weight']} == {bf16_launches['layer_norm']} "
                  f"== {BF16_GRAD_STEPS} x {per_step['layer_norm']}")
    cc_shapes = bf16_grad_shapes({key: row["cc"] for key, row in ln_shapes().items()})
    check_ln_recording(checks, f"{BF16_GRAD_STEPS} CC steps, bf16 gradients", ln_seen,
                       cc_shapes, bf16_launches, BF16_GRAD_STEPS)
    check_k1(checks, f"{BF16_GRAD_STEPS} CC steps, bf16 gradients", bf16_launches,
             k1_routed(vl_attention_shapes(state.model.cfg, TRAIN_T, TRAIN_R), BF16_GRAD_STEPS),
             no_k2=False)
    checks.expect(bf16_launches["attention_bwd"] == BF16_GRAD_STEPS * per_step["attention_bwd"]
                  == bf16_launches["attention_bwd_tc"],
                  f"attention_bwd launches {bf16_launches['attention_bwd']} == {BF16_GRAD_STEPS} "
                  f"x {per_step['attention_bwd']}, all on the tensor cores")
    # kernels vs plain ops: a bf16-gradient step at fp32 compute (K4 takes
    # fp32 x with bf16 weight and bias), dropout on, the same masks
    cfg32 = state.model.cfg.replace(compute_dtype="float32")
    m32 = ViLBERTForPretraining(cfg32)
    m32.load_state_dict(state.model.state_dict())
    m32 = m32.to(DEVICE)
    del state, opt
    batch = to_device(host_batch(bench_batch(cfg32, TRAIN_CHECK_BATCH, SEED + 5), cfg32), DEVICE)
    loss_fn = make_pretrain_loss_fn(cfg32, lm_gather=LM_GATHER)
    names = [n for n, _ in m32.named_parameters()]
    result = {}
    for plain in (False, True):
        use_plain_ops(m32, plain)
        set_dropout_generator(m32, torch.Generator().manual_seed(SEED + 7))
        before = read_launches()["layer_norm_bf16_weight"]
        loss, _, grads = bf16_grads(m32, loss_fn, batch, names)
        torch.cuda.synchronize()
        result[plain] = (loss.item(), grads, read_launches()["layer_norm_bf16_weight"] - before)
    del m32
    (lk, gk, nk), (lp, gp, np_) = result[False], result[True]
    top = max(float(g.float().abs().max()) for g in gp.values())
    worst = max(float((gk[n].float() - gp[n].float()).abs().max())
                / (bf16_bound(gp[n].float()) + 1e-6 * top) for n in gp)
    loss_err = abs(lk - lp) / abs(lp)
    checks.expect(all(g.dtype == torch.bfloat16 for g in gk.values()) and nk == per_step[
        "layer_norm"] and np_ == 0 and math.isfinite(lk) and loss_err <= 1e-5 and worst <= 1.0,
        f"B={TRAIN_CHECK_BATCH} fp32-compute bf16-gradient step with dropout, kernels vs plain "
        f"ops: bf16 gradients, {nk} K4 launches on the bf16-weight instantiation; loss "
        f"{lk:.6f} vs {lp:.6f} (rel {loss_err:.3e} <= 1e-5), worst gradient at {worst:.3e} of "
        f"its bound (bf16_bound + 1e-6 of the largest; <= 1)")
    del result, gk, gp, batch
    checks.end_phase("bf16 gradients")

    # bf16-weight K4 timed at the CC and multi-task shapes (the text
    # embedding's in bf16, as the bf16-gradient step gives it)
    shapes = {}
    for key, row in ln_shapes().items():
        if row["cc"] or row["multitask"]:
            new = (*key[:2], "bfloat16", key[3])
            have = shapes.setdefault(new, {"label": row["label"], "cc": 0, "multitask": 0})
            if have["label"] != row["label"]:
                have["label"] += "; " + row["label"]
            have["cc"] += row["cc"]
            have["multitask"] += row["multitask"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    times = time_layer_norm(checks, shapes, card, err, g, paths=("cc", "multitask"),
                            wdtype=torch.bfloat16)
    checks.end_phase("bf16-weight K4 timing")

    # 2. one flagship iteration with --optim radam
    tasks = flagship_tasks()
    loaders, val_loaders = multitask_loaders(tasks, trainer.model_cfg.vocab_size)
    losses = []
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        radam = train_tasks.train(
            multitask_args(os.path.join(tmp, "radam"), ["--optim", "radam", "--num_iterations",
                                                        "1"]),
            tasks, loaders, val_loaders=val_loaders,
            hooks=[lambda e, it, tr, m: losses.extend((k, float(v["loss"])) for k, v in m.items())])
        torch.cuda.synchronize()
        radam_launches = read_launches()
    counts = {lb: st.count for lb, st in radam.optimizer.state.items()}
    log(f"  --optim radam iteration: " + ", ".join(f"{k} {v:.6f}" for k, v in losses)
        + f"; label counts {counts}; launches {radam_launches}")
    checks.expect(type(radam.optimizer).__name__ == "ReferenceRAdam" and len(losses) == len(tasks)
                  and all(math.isfinite(v) for _, v in losses)
                  and counts == {"base": len(tasks), "head": len(tasks)},
                  f"RAdam: {len(losses)} task losses finite, each label stepped by every task")
    want = multitask_launches(tasks, radam.model_cfg, 1, 0)
    checks.expect(all(radam_launches[k] == n for k, n in want.items()),
                  f"RAdam iteration launches {({k: radam_launches[k] for k in want})} == {want}")
    del radam, loaders, val_loaders

    # 3. the CC resume check: fp32, dropout off, one held batch
    cfg_r = ModelConfig.from_json_file(CONFIG).replace(
        compute_dtype="float32", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0)
    held = [bench_batch(cfg_r, RESUME_BATCH, SEED + 13)]
    opt_cfg = OptimizerConfig(learning_rate=1e-4, beta2=0.98, schedule="warmup_linear",
                              warmup_proportion=0.5)

    def fresh():
        model = ViLBERTForPretraining(cfg_r, generator=torch.Generator().manual_seed(SEED))
        model.cls.dropout.rate = 0.0  # the fixed-rate fuse site
        return model

    kw = dict(num_steps=4, device=DEVICE, lm_gather=LM_GATHER, log_every=0)
    whole = run_pretraining(cfg_r, opt_cfg, held, model=fresh(), **kw)
    ckpt = os.path.join(tmp, "cc_ckpt")
    mngr = CheckpointManager(ckpt)

    def interrupt(step, st, metrics):
        if step + 1 == 2:
            mngr.save(2, train_state_dict(st))
            raise _Interrupt

    try:
        run_pretraining(cfg_r, opt_cfg, held, model=fresh(), hooks=[interrupt], **kw)
    except _Interrupt:
        pass
    resumed = run_pretraining(cfg_r, opt_cfg, held, model=fresh(), resume_dir=ckpt, **kw)
    pairs = [(n, a, b) for tree_a, tree_b in (
        (whole.model.state_dict(), resumed.model.state_dict()),
        (whole.optimizer.state.mu, resumed.optimizer.state.mu),
        (whole.optimizer.state.nu, resumed.optimizer.state.nu)) for n, a in tree_a.items()
        for b in (tree_b[n],)]
    bitwise = all(torch.equal(a, b) for _, a, b in pairs)
    rel = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30) for _, a, b in pairs)
    log(f"  resume: 2 steps + checkpoint + 2 resumed steps vs 4 uninterrupted (fp32, B="
        f"{RESUME_BATCH}, one held batch, dropout off): bitwise {bitwise}, worst difference "
        f"{rel:.3e} of its tensor's max over {len(pairs)} tensors")
    checks.expect(resumed.step == 4 and resumed.optimizer.state.count == 4 and (
        bitwise or rel <= 1e-6), f"resumed run equals the uninterrupted one (bitwise {bitwise}, "
                                 f"{rel:.3e} <= 1e-6 of each tensor's max)")
    del whole, resumed, pairs

    # 4. the flagship trainer (phases 8-9) saved and restored into a new one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = trainer.save_checkpoint()
    save_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    loaders, val_loaders = multitask_loaders(tasks, trainer.model_cfg.vocab_size)
    fresh_trainer = train_tasks.build_trainer(
        multitask_args(os.path.join(tmp, "restored")), tasks, loaders, val_loaders=val_loaders)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = fresh_trainer.restore_checkpoint(directory=os.path.dirname(path))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, fresh_trainer.model.state_dict()[n])
               for n, a in trainer.model.state_dict().items())
    for tree_a, tree_b in ((trainer.optimizer.state.mu, fresh_trainer.optimizer.state.mu),
                           (trainer.optimizer.state.nu, fresh_trainer.optimizer.state.nu)):
        same = same and all(torch.equal(a, tree_b[n]) for n, a in tree_a.items())
    host = (fresh_trainer.optimizer.state.count, fresh_trainer.global_step, fresh_trainer.epoch,
            fresh_trainer.controller.state_dict(), fresh_trainer.schedule.state_dict(),
            fresh_trainer.metrics_logger.state_dict())
    want_host = (trainer.optimizer.state.count, trainer.global_step, trainer.epoch,
                 trainer.controller.state_dict(), trainer.schedule.state_dict(),
                 trainer.metrics_logger.state_dict())
    log(f"  flagship checkpoint (step {step}): {size / 1e9:.3f} GB, saved in {save_s:.2f} s, "
        f"restored in {restore_s:.2f} s [{card}]")
    checks.expect(same and host == want_host and step == trainer.global_step,
                  "restored trainer: parameters and both moments bitwise, count, global step, "
                  "epoch, controllers, schedule and logger equal")
    del fresh_trainer
    checks.end_phase("training options")
    out = {"bf16_launches": bf16_launches, "radam_launches": radam_launches,
           "checkpoint_gb": size / 1e9, "save_s": save_s, "restore_s": restore_s,
           "resume_bitwise": bitwise}
    return times, out


# -- phase 12 ----------------------------------------------------------------

#: K1 and K2 past 512 keys (the single-stream baseline's GuessWhatPointing
#: is 256 + 306 = 562): the long variants at Sq x Sk edges of 511, 512, 513,
#: 562 and 1024 (KERNEL_MAX_KEYS), one query or key against 1024, at both
#: head widths
LONG_1024_CASES = [
    (12, 64, 511, 511), (8, 128, 512, 512), (12, 64, 513, 513), (8, 128, 562, 562),
    (12, 64, 562, 562), (8, 128, 1024, 1024), (12, 64, 1024, 1024), (12, 64, 1, 1024),
    (8, 128, 1024, 1), (8, 128, 511, 1024), (12, 64, 1024, 513), (8, 128, 562, 512),
]


#: (label, heads, head_dim, S, batch) where phase 12 times K2: the cap
LONG_TIMED = (("self 1024 h12", 12, 64, 1024, 8), ("self 1024 h8", 8, 128, 1024, 8))


def phase_long_kernels(checks: Checks, err: dict, card: str) -> dict:
    """(a) The long K1 (``long_tc`` bf16, ``cc`` fp32) and K2 (``wg`` bf16,
    with ``long_tc`` by name beside it, ``long`` fp32) at LONG_1024_CASES,
    rates 0 and 0.1, against the plain versions within phase 3's bounds,
    each call on its variant's counter; a length past the cap refused in
    both directions; K2 timed at LONG_TIMED."""
    import torch

    from vilbert_tpu_torch.ops.attention import (
        KERNEL_MAX_KEYS,
        attention,
        attention_bwd,
        attention_bwd_kernel,
        attention_bwd_ref,
        attention_ref,
        bwd_variant,
        fwd_variant,
    )

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    B = 2
    for heads, d, sq, sk in LONG_1024_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v, cot, bias = _attention_operands(g, B, heads, d, sq, sk, dtype)
            for rate in (0.0, 0.1):
                kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
                fv, bv = fwd_variant(dtype, sq, sk, d), bwd_variant(dtype, sq, sk, d)
                got, on_fv = counted(attention, fv, lambda: attention(q, k, v, bias, **kw))
                e, bnd, ok = _fwd_error(got, attention_ref(q, k, v, bias, **kw), name)
                got, on_bv = counted(attention_bwd, bv,
                                     lambda: attention_bwd(q, k, v, bias, cot, **kw))
                want = attention_bwd_ref(q, k, v, bias, cot, **kw)
                eb, okb = _bwd_errors(got, want, name, bias)
                torch.cuda.synchronize()
                track_error(err, "attention_fwd", fv, e)
                track_error(err, "attention_bwd", bv, eb)
                checks.expect(ok and okb and on_fv and on_bv,
                              f"attention h={heads} d={d} Sq={sq} Sk={sk} {name} rate {rate} "
                              f"[{fv}, {bv}]: fwd max|err| {e:.3e} (<= {bnd:.3e}), bwd max|err| "
                              f"{eb:.3e}")
                if bv == "wg":  # the mma.sync variant it took over, by name
                    got, on_lt = counted(attention_bwd, "long_tc", lambda: attention_bwd_kernel(
                        q, k, v, bias, cot, variant="long_tc", **kw))
                    el, okl = _bwd_errors(got, want, name, bias)
                    track_error(err, "attention_bwd", "long_tc", el)
                    checks.expect(okl and on_lt, f"attention bwd h={heads} d={d} Sq={sq} "
                                                 f"Sk={sk} rate {rate} [long_tc, named]: max|err| "
                                                 f"{el:.3e}")
    over = KERNEL_MAX_KEYS + 1
    for sq, sk in ((over, 20), (20, over)):
        q, k, v, cot, bias = _attention_operands(g, 1, 12, 64, sq, sk, torch.bfloat16)
        refused = []
        for fn in (lambda: attention(q, k, v, bias, num_heads=12),
                   lambda: attention_bwd(q, k, v, bias, cot, num_heads=12)):
            try:
                fn()
                refused.append(False)
            except ValueError:
                refused.append(True)
        checks.expect(refused == [sk == over, True],
                      f"Sq={sq} Sk={sk}: K1 refused {refused[0]} (past the cap only in Sk), "
                      f"K2 refused {refused[1]}")
    # K2 at the cap: the routed variant beside the one it took over, SDPA's
    # backward, the plain version and the bound
    times = {}
    for label, heads, d, s, B in LONG_TIMED:
        q, k, v, cot, bias = _attention_operands(g, B, heads, d, s, s, torch.bfloat16)
        kw = dict(num_heads=heads)
        lib = library_attention_fns(q, k, v, bias, cot, heads, d)
        row = timed_row({**bwd_fns(q, k, v, bias, cot, kw), **lib}, "kernel", "plain",
                        *attention_cost(B, heads, d, s, s)["bwd"], BF16_TC_FLOPS, iters=5,
                        library=lambda dev: dev["library_fwd_bwd"] - dev["library"])
        row["variant"] = bwd_variant(torch.bfloat16, s, s, d)
        times[("attention_bwd", label, 0.0)] = row
        log(f"  attention bwd {label} B={B} h={heads} d={d} {s}x{s} bf16 rate 0 "
            f"[{row['variant']}]: {row_text(row)} [{card}]")
    checks.end_phase("K1 and K2 past 512 keys")
    return times


# -- phase 13 ----------------------------------------------------------------

#: the single-stream baseline (``--baseline``) at its published width: 12
#: layers of 768, 12 heads of 64, intermediate 3072, regions by Linear(2048,
#: 768); one sequence of T + R tokens
BASELINE_CONFIG = "configs/bert_base_baseline.json"
BASE_VQA_BATCH = TIME_BATCH  # TASK1's eval batch size
#: the baseline's retrieval sequence: a caption of 30 tokens and 101 regions
BASE_RET_CAPTIONS, BASE_RET_ZERO_SHOT = 4, 2


def baseline_ln_forward(cfg, B: int, T: int, R: int, heads=()) -> dict:
    """K4's launches in one forward of the baseline, {(rows, H, dtype name,
    residual): count}: the text embedding's and the image embedding's in
    fp32 (the type embedding's fp32 table promotes the image sum), two a
    layer over the B (T + R) rows in the compute dtype with the residual;
    ``heads`` adds (rows, H) of the heads' LayerNorms in the compute
    dtype."""
    dt, h = cfg.compute_dtype, cfg.hidden_size
    out = collections.Counter()
    out[(B * T, h, "float32", False)] += 1
    out[(B * R, h, "float32", False)] += 1
    out[(B * (T + R), h, dt, True)] += 2 * cfg.num_hidden_layers
    for rows, hh in heads:
        out[(rows, hh, dt, False)] += 1
    return dict(out)


def phase_baseline_vqa(checks: Checks, card: str) -> tuple:
    """(b) ``run_eval`` with the baseline (``--baseline``) on synthetic TASK1
    at B=1024, T=23, R=101 (124 keys: K1 on "tc"), launches and K4 shapes;
    bf16 and fp32 logits against the plain ops at B=256; questions/s."""
    import torch

    from vilbert_tpu_torch.cli.eval_tasks import build_model, run_eval, synthetic_vqa_loader
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks
    from vilbert_tpu_torch.models.layers import use_plain_ops

    cfg = ModelConfig.from_json_file(BASELINE_CONFIG)
    task = task1()
    t0 = time.time()
    model = build_model(cfg, seed=SEED, device=DEVICE, baseline=True)
    log(f"  model {BASELINE_CONFIG} (--baseline): {sum(p.numel() for p in model.parameters())} "
        f"params, compute {cfg.compute_dtype}, built in {time.time() - t0:.1f} s")
    loader = synthetic_vqa_loader(cfg, task, num=BASE_VQA_BATCH, batch_size=BASE_VQA_BATCH)
    with tempfile.TemporaryDirectory() as out_dir, recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        metrics, records = run_eval(model, cfg, {"TASK1": task}, {"TASK1": loader},
                                    output_dir=out_dir, split=task.val_split)["TASK1"]
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"  run_eval --baseline TASK1 B={BASE_VQA_BATCH}: loss {metrics['loss']:.6f} score "
        f"{metrics['score']:.6f} records {len(records)} in {time.time() - t0:.1f} s; launches "
        f"{launches}")
    n, d = cfg.num_hidden_layers, cfg.hidden_size // cfg.num_attention_heads
    check_k1(checks, f"run_eval --baseline, {n} layers over {T + R} keys", launches,
             k1_routed([(T + R, T + R, d)] * n))
    check_ln_recording(checks, "run_eval --baseline", ln_seen,
                       baseline_ln_forward(cfg, BASE_VQA_BATCH, T, R), launches)
    checks.expect(math.isfinite(metrics["loss"]) and len(records) == BASE_VQA_BATCH
                  and all(0 <= r["answer"] < 3129 for r in records),
                  "loss finite, one record per question, answers in the 3129 labels")

    x = random_batch(cfg, CHECK_BATCH, SEED + 16)
    head = ("vil_prediction",)
    model32 = BaseBertForVLTasks(cfg.replace(compute_dtype="float32"))
    model32.load_state_dict(model.state_dict())
    model32 = model32.to(DEVICE).eval()
    logits = {}
    for name, m in (("fp32", model32), ("bf16", model)):
        with torch.inference_mode():
            logits[name, "kernels"] = m(**x, heads=head).vil_prediction
            logits[name, "plain"] = use_plain_ops(m)(**x, heads=head).vil_prediction
            use_plain_ops(m, False)
    del model32
    scale = max(1.0, float(logits["fp32", "plain"].abs().max()))
    for name, bound in (("fp32", 1e-3), ("bf16", 5e-2 * scale)):
        kern, plain = logits[name, "kernels"], logits[name, "plain"]
        e = float((kern - plain).abs().max())
        checks.expect(bool(torch.isfinite(kern).all()) and e <= bound,
                      f"baseline B={CHECK_BATCH} {name} logits, kernels vs plain ops: max|err| "
                      f"{e:.3e} <= {bound:.3e}")
    x = random_batch(cfg, BASE_VQA_BATCH, SEED + 17)
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: model(**x, heads=head), iters=10, warmup=2)
    rate = BASE_VQA_BATCH / ms * 1e3
    log(f"  baseline forward B={BASE_VQA_BATCH} T={T} R={R} bf16 kernels: {ms:.3f} ms = "
        f"{rate:.1f} questions/s [{card}]")
    checks.end_phase("baseline VQA")
    return launches, rate


# -- phase 14 ----------------------------------------------------------------

def phase_baseline_train(checks: Checks, tmp: str, card: str) -> tuple:
    """(c) The baseline's CC step through ``train_concap.train --baseline``
    (``run_pretraining`` with ``model_family="basebert"``) at B=256, T=36,
    R=37 (73 keys), ``lm_gather`` 12, dropout 0.1: launches a step, K1 on
    "tc" and K2 on "wg" (``bwd_variant`` at d = 64); an fp32 step with
    dropout through the kernels and the plain ops (phase 6's bounds);
    samples/s of the bf16 step."""
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config, train
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.basebert import BaseBertForPretraining
    from vilbert_tpu_torch.models.layers import set_dropout_generator, use_plain_ops
    from vilbert_tpu_torch.ops.attention import bwd_variant, fwd_variant
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

    args = build_parser().parse_args([
        "--synthetic", "--baseline", "--config", BASELINE_CONFIG, "--batch_size",
        str(TRAIN_BATCH), "--num_steps", str(TRAIN_STEPS), "--seed", str(SEED), "--device",
        DEVICE, "--output_dir", os.path.join(tmp, "cc_baseline"),
    ])
    losses = []
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        state = train(args, hooks=[lambda step, st, m: losses.append(float(m["loss"]))])
        torch.cuda.synchronize()
        launches = read_launches()
    model, cfg = state.model, state.model.cfg
    log(f"  train --baseline {BASELINE_CONFIG}: {type(model).__name__}, "
        f"{sum(p.numel() for p in model.parameters())} params, losses "
        f"{[round(v, 6) for v in losses]}; launches {launches}")
    n = cfg.num_hidden_layers
    checks.expect(type(model) is BaseBertForPretraining and cfg.hidden_dropout_prob == 0.1
                  == cfg.attention_probs_dropout_prob and len(losses) == TRAIN_STEPS
                  and all(math.isfinite(v) for v in losses),
                  "BaseBertForPretraining, dropout 0.1, losses finite")
    s, d = TRAIN_T + TRAIN_R, cfg.hidden_size // cfg.num_attention_heads
    for name, variant in (("attention", fwd_variant(torch.bfloat16, s, s, d)),
                          ("attention_bwd", bwd_variant(torch.bfloat16, s, s, d))):
        checks.expect(launches[name] == launches[f"{name}_{variant}"] == TRAIN_STEPS * n,
                      f"{name} launches {launches[name]} == {variant} "
                      f"{launches[f'{name}_{variant}']} == {TRAIN_STEPS} x {n} ({s} keys)")
    B = TRAIN_BATCH
    shapes = baseline_ln_forward(cfg, B, TRAIN_T, TRAIN_R, [
        (B * LM_GATHER, cfg.hidden_size), (B * TRAIN_R, cfg.hidden_size)])
    check_ln_recording(checks, f"{TRAIN_STEPS} baseline CC steps", ln_seen, shapes, launches,
                       TRAIN_STEPS)

    cfg32 = cfg.replace(compute_dtype="float32")
    m32 = BaseBertForPretraining(cfg32)
    m32.load_state_dict(model.state_dict())
    m32 = m32.to(DEVICE)
    batch = to_device(host_batch(bench_batch(cfg32, TRAIN_CHECK_BATCH, SEED + 5), cfg32), DEVICE)
    loss_fn = make_pretrain_loss_fn(cfg32, lm_gather=LM_GATHER)
    result = {}
    for plain in (False, True):
        use_plain_ops(m32, plain)
        set_dropout_generator(m32, torch.Generator().manual_seed(SEED + 7))
        m32.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m32, batch)
        loss.backward()
        result[plain] = (loss.item(), {k: p.grad.clone() for k, p in m32.named_parameters()})
    (lk, gk), (lp, gp) = result[False], result[True]
    top = max(float(g.abs().max()) for g in gp.values())
    worst = max(float((gk[k] - gp[k]).abs().max())
                / (1e-3 * float(gp[k].abs().max()) + 1e-6 * top) for k in gp)
    loss_err = abs(lk - lp) / abs(lp)
    checks.expect(math.isfinite(lk) and loss_err <= 1e-5 and worst <= 1.0,
                  f"baseline B={TRAIN_CHECK_BATCH} fp32 step with dropout, kernels vs plain ops: "
                  f"loss {lk:.6f} vs {lp:.6f} (rel {loss_err:.3e} <= 1e-5), worst gradient at "
                  f"{worst:.3e} of its bound (<= 1)")
    del m32, result, gk, gp

    opt, _ = build_optimizer(optimizer_config(args, schedule="constant"),
                             dict(model.named_parameters()), 1000, family=model.family)
    step = make_train_step(make_pretrain_loss_fn(cfg, lm_gather=LM_GATHER), opt)
    batch = to_device(host_batch(bench_batch(cfg, B, SEED + 6), cfg), DEVICE)
    set_dropout_generator(model, torch.Generator().manual_seed(SEED))
    step(model, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        metrics = step(model, batch)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / 4
    rate = B / dt
    log(f"  baseline train step B={B} T={TRAIN_T} R={TRAIN_R} bf16 kernels: {dt * 1e3:.2f} "
        f"ms/step = {rate:.1f} samples/s (loss {loss:.4f}) [{card}]")
    del state, model, opt, batch
    checks.end_phase("baseline CC step")
    return launches, rate


# -- phase 15 ----------------------------------------------------------------

def phase_nce(checks: Checks, tmp: str, card: str) -> dict:
    """(d) The two-stream CC step with ``--visual_target 2`` (NCE over 128
    negatives) at B=256, T=36, R=37: two runs of 2 steps from one seed give
    the same finite losses; samples/s and peak memory of the step."""
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config, train
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

    args = build_parser().parse_args([
        "--synthetic", "--config", CONFIG, "--visual_target", "2", "--batch_size",
        str(TRAIN_BATCH), "--num_steps", "2", "--seed", str(SEED), "--device", DEVICE,
        "--output_dir", os.path.join(tmp, "cc_nce"),
    ])
    runs = []
    for _ in range(2):
        losses = []
        reset_launches()
        state = train(args, hooks=[lambda step, st, m: losses.append(
            (float(m["loss"]), float(m["masked_loss_v"])))])
        torch.cuda.synchronize()
        runs.append(losses)
    launches = read_launches()
    model, cfg = state.model, state.model.cfg
    log(f"  train --visual_target 2 (num_negative {cfg.num_negative}): (loss, NCE loss) a step "
        f"{runs[0]} and again from the seed {runs[1]}; launches {launches}")
    checks.expect(cfg.visual_target == 2 and cfg.v_target_size == cfg.v_feature_size
                  and len(runs[0]) == 2 and runs[0] == runs[1]
                  and all(math.isfinite(v) for pair in runs[0] for v in pair),
                  "NCE: losses finite, two runs from one seed equal")
    opt, _ = build_optimizer(optimizer_config(args, schedule="constant"),
                             dict(model.named_parameters()), 1000)
    generator = torch.Generator().manual_seed(SEED)
    step = make_train_step(make_pretrain_loss_fn(cfg, lm_gather=LM_GATHER,
                                                 nce_generator=generator), opt)
    b = bench_batch(cfg, TRAIN_BATCH, SEED + 18)
    b["image_target"] = b["image_feat"][:, 1:].copy()  # NCE scores features
    batch = to_device(host_batch(b, cfg), DEVICE)
    set_dropout_generator(model, generator)
    step(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        metrics = step(model, batch)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / 3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  NCE train step B={TRAIN_BATCH} T={TRAIN_T} R={TRAIN_R} bf16 kernels: "
        f"{dt * 1e3:.2f} ms/step = {TRAIN_BATCH / dt:.1f} samples/s, peak memory {peak:.2f} GB "
        f"(loss {loss:.4f}) [{card}]")
    checks.expect(math.isfinite(loss), "NCE held-batch steps finite")
    del state, model, opt, batch
    checks.end_phase("NCE")
    return {"samples_per_s": TRAIN_BATCH / dt, "peak_gb": peak, "launches": launches}


# -- phase 16 ----------------------------------------------------------------

def baseline_tasks() -> dict:
    """The flagship tasks the baseline has heads for: all but NLVR2, Visual
    Entailment and GQA (``train.multitask.BASELINE_REFUSED_TYPES``)."""
    from vilbert_tpu_torch.train.multitask import BASELINE_REFUSED_TYPES

    return {k: t for k, t in flagship_tasks().items() if t.type not in BASELINE_REFUSED_TYPES}


def baseline_task_geometry(task) -> tuple:
    """(model batch, sequence length) of a baseline task's step: its batch
    (x4 for retrieval's pairs) over T + R tokens."""
    return (task.batch_size * (4 if task.process == "retrieval" else 1),
            task.max_seq_length + task.max_region_num)


def baseline_task_ln_shapes(tasks: dict, cfg) -> dict:
    """``baseline_ln_forward`` of one step of each of ``tasks`` (no head has
    a LayerNorm), summed: K4's launches in one baseline iteration."""
    out = collections.Counter()
    for task in tasks.values():
        out.update(baseline_ln_forward(cfg, baseline_task_geometry(task)[0], task.max_seq_length,
                                       task.max_region_num))
    return dict(out)


def baseline_multitask_launches(tasks: dict, cfg, steps: int) -> dict:
    """K1 and K2 of ``steps`` baseline steps of every task: one a layer,
    over T + R keys, on the variants ``fwd_variant`` and ``bwd_variant``
    pick (K2 "wg": every task's T + R is past 64, d = 64)."""
    import torch

    from vilbert_tpu_torch.ops.attention import bwd_variant, fwd_variant

    out = collections.Counter()
    d = cfg.hidden_size // cfg.num_attention_heads
    for task in tasks.values():
        s = baseline_task_geometry(task)[1]
        for name, variant in (("attention", fwd_variant(torch.bfloat16, s, s, d)),
                              ("attention_bwd", bwd_variant(torch.bfloat16, s, s, d))):
            out[name] += steps * cfg.num_hidden_layers
            out[f"{name}_{variant}"] += steps * cfg.num_hidden_layers
    return dict(out)


def time_task_steps(trainer, card: str, label: str = "") -> tuple:
    """Each task's step on ``trainer``'s model (device-synced, one batch held
    on the card, one warm-up and 3 timed): ({task: row}, ms, samples)."""
    import torch

    times, total_ms, total_samples = {}, 0.0, 0
    lr = float(trainer.schedule(trainer.global_step))
    for key, task in trainer.tasks.items():
        batch = task.next_batch()
        task.step_fn(trainer.model, batch, lr)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            metrics = task.step_fn(trainer.model, batch, lr)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        samples = task.cfg.batch_size
        total_ms, total_samples = total_ms + ms, total_samples + samples
        times[key] = {"ms": ms, "samples_per_s": samples / ms * 1e3}
        log(f"  {label}step {key} B={samples} bf16 kernels: {ms:.2f} ms = "
            f"{samples / ms * 1e3:.1f} samples/s (loss {loss:.4f}) [{card}]")
    return times, total_ms, total_samples


def phase_baseline_multitask(checks: Checks, tmp: str, card: str) -> tuple:
    """(e) One iteration of ``cli/train_tasks.py::train --baseline`` over the
    flagship tasks it has heads for, each at its batch size and geometry
    (no task token: the baseline takes none), bf16, dropout 0.1: launches
    by variant (GuessWhatPointing's 562 keys on "long_tc"), K4's by shape,
    finite losses, each task's step time."""
    import torch

    from vilbert_tpu_torch.cli.train_tasks import build_parser, train

    tasks = baseline_tasks()
    loaders, _ = multitask_loaders(tasks, 30522)
    args = build_parser().parse_args([
        "--config", BASELINE_CONFIG, "--baseline", "--lr_scheduler", "mannul", "--head_lr",
        "1e-4", "--seed", str(SEED), "--device", DEVICE, "--num_iterations", "1",
        "--output_dir", os.path.join(tmp, "mt_baseline"),
    ])
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording_ln_shapes() as ln_seen:
        reset_launches()
        t0 = time.time()
        trainer = train(args, tasks, loaders, hooks=[
            lambda e, it, tr, m: losses.extend((k, float(v["loss"])) for k, v in m.items())])
        torch.cuda.synchronize()
        launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  train --baseline {BASELINE_CONFIG}, {len(tasks)} tasks ({', '.join(tasks)}) in "
        f"{time.time() - t0:.1f} s, peak memory {peak:.2f} GB: "
        + ", ".join(f"{k} {v:.6f}" for k, v in losses) + f"; launches {launches}")
    checks.expect(trainer.model.family == "basebert" and len(losses) == len(tasks)
                  and all(math.isfinite(v) for _, v in losses),
                  f"{len(losses)} task steps of the baseline, every loss finite")
    want = baseline_multitask_launches(tasks, trainer.model_cfg, 1)
    got = {k: launches.get(k, 0) for k in ("attention", "attention_tc", "attention_long_tc",
                                          "attention_cc", "attention_wg", "attention_bwd",
                                          "attention_bwd_tc",
                                          "attention_bwd_long_tc", "attention_bwd_long",
                                          "attention_bwd_wg")}
    checks.expect(got == {k: want.get(k, 0) for k in got},
                  f"K1 and K2 launches by variant {got} == {want} (GuessWhatPointing's "
                  f"{tasks['TASK17'].max_seq_length + tasks['TASK17'].max_region_num} keys "
                  f"included)")
    check_ln_recording(checks, "train --baseline, one iteration", ln_seen,
                       baseline_task_ln_shapes(tasks, trainer.model_cfg), launches)
    times, total_ms, total = time_task_steps(trainer, card, "baseline ")
    log(f"  baseline steps of the {len(tasks)} tasks: {total_ms:.1f} ms = "
        f"{total / total_ms * 1e3:.1f} samples/s [{card}]")
    del trainer
    checks.end_phase("baseline multi-task")
    return launches, times


# -- phase 17 ----------------------------------------------------------------

def phase_baseline_retrieval(checks: Checks, tmp: str, card: str) -> tuple:
    """(f) Retrieval with the baseline through ``cli/eval_retrieval.py``'s
    ``run`` (``--baseline``): phase 10's pool (1,000 images in chunks of 500,
    captions of 30 tokens), fine-tuned (``BaseBertForVLTasks``; no
    ``--fast_mode``, which the baseline refuses) over BASE_RET_CAPTIONS
    captions and zero-shot over BASE_RET_ZERO_SHOT: 131 keys, K1 on the
    variant ``fwd_variant`` picks there; launches and K4 shapes; bf16
    scores against the plain ops; captions/s."""
    import numpy as np
    import torch

    from vilbert_tpu_torch.cli.eval_retrieval import run
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.basebert import BaseBertForPretraining, BaseBertForVLTasks
    from vilbert_tpu_torch.models.layers import use_plain_ops

    store, keys, entries = retrieval_world()
    cfg = ModelConfig.from_json_file(BASELINE_CONFIG)
    chunks = RET_POOL // RET_CHUNK
    n, d = cfg.num_hidden_layers, cfg.hidden_size // cfg.num_attention_heads
    out, launches = {}, {}
    for mode, cls, captions in (("fine-tuned", BaseBertForVLTasks, BASE_RET_CAPTIONS),
                                ("zero-shot", BaseBertForPretraining, BASE_RET_ZERO_SHOT)):
        model = cls(cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
        extra = ["--baseline"] + (["--zero_shot"] if mode == "zero-shot" else [])
        args = retrieval_args(tmp, extra, config=BASELINE_CONFIG)
        with recording_ln_shapes() as ln_seen:
            reset_launches()
            t0 = time.perf_counter()
            metrics = run(args, store=store, keys=keys, caption_entries=entries[:captions],
                          model=model)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[mode] = read_launches()
        forwards = captions * chunks
        out[mode] = {"captions_per_s": captions / dt, **metrics}
        log(f"  eval_retrieval --baseline ({mode}): {metrics} in {dt:.1f} s = "
            f"{captions / dt:.3f} captions/s (pool load included) [{card}]; launches "
            f"{launches[mode]}")
        checks.expect(metrics["num_captions"] == captions and metrics["pool_size"] == RET_POOL
                      and all(math.isfinite(v) for v in metrics.values()),
                      f"{mode}: {captions} captions ranked against {RET_POOL} images, finite")
        s = RET_T + RET_R
        check_k1(checks, f"{mode}: {forwards} forwards x {n} ({s} keys)", launches[mode],
                 k1_routed([(s, s, d)] * n, forwards))
        heads = [] if mode == "fine-tuned" else [(RET_CHUNK * RET_T, cfg.hidden_size),
                                                  (RET_CHUNK * RET_R, cfg.hidden_size)]
        check_ln_recording(checks, f"eval_retrieval --baseline {mode}", ln_seen,
                           baseline_ln_forward(cfg, RET_CHUNK, RET_T, RET_R, heads),
                           launches[mode], forwards)
        if mode == "fine-tuned":
            fine_tuned = model  # checked against the plain ops below
        del model
    # bf16 scores, kernels against the plain ops, 2 captions
    from vilbert_tpu_torch.cli.eval_retrieval import load_pool
    from vilbert_tpu_torch.data.tasks import _pad_text
    from vilbert_tpu_torch.data.tokenization import add_special_single, load_tokenizer
    from vilbert_tpu_torch.eval.retrieval import make_vil_logit_scorer, score_matrix

    model = fine_tuned
    tokenizer = load_tokenizer(None, cfg.vocab_size)
    pool = load_pool(store, keys, RET_R, cfg.v_feature_size)
    caps = []
    for text, _ in entries[:RET_CHECK_CAPTIONS]:
        q, m, sg = _pad_text(add_special_single(
            tokenizer, list(tokenizer.encode(text))[:RET_T - 2]), RET_T)
        caps.append({"question": q, "input_mask": m, "segment_ids": sg})
    scores = {}
    for plain in (False, True):
        scores[plain] = score_matrix(make_vil_logit_scorer(use_plain_ops(model, plain)), caps,
                                     pool, chunk=RET_CHUNK, device=DEVICE)
    use_plain_ops(model, False)
    scale = max(1.0, float(np.abs(scores[True]).max()))
    e = float(np.abs(scores[False] - scores[True]).max())
    checks.expect(np.isfinite(scores[False]).all() and e <= 5e-2 * scale,
                  f"baseline bf16 retrieval scores, kernels vs plain ops: max|err| {e:.3e} <= "
                  f"{5e-2 * scale:.3e} (5e-2 per unit of logit scale)")
    del model, fine_tuned, pool
    checks.end_phase("baseline retrieval")
    return launches, out


# -- phase 18 ----------------------------------------------------------------

#: (label, heads, head_dim, Sq, Sk, B, rates, backward) of the baseline's
#: attention shapes off the multi-task path: VQA eval (124 keys), the CC
#: step (73, with dropout), retrieval (131: long_tc); the backward where
#: the path trains
BASELINE_ATTENTIONS = (
    ("baseline VQA self", 12, 64, T + R, T + R, BASE_VQA_BATCH, (0.0,), False),
    ("baseline CC self", 12, 64, TRAIN_T + TRAIN_R, TRAIN_T + TRAIN_R, TRAIN_BATCH, (0.0, 0.1),
     True),
    ("baseline retrieval self", 12, 64, RET_T + RET_R, RET_T + RET_R, RET_CHUNK, (0.0,), False),
)
#: the baseline's paths whose K4 shapes phase 18 times
BASELINE_LN_PATHS = ("baseline_vqa", "baseline_cc", "baseline_multitask")


def baseline_attentions() -> tuple:
    """BASELINE_ATTENTIONS and the multi-task path's: one entry for each
    (model batch, T + R) of the tasks the baseline trains (tasks of one
    geometry share it), rates 0 and 0.1, with the backward."""
    by_shape = {}
    for task in baseline_tasks().values():
        by_shape.setdefault(baseline_task_geometry(task), []).append(task.name)
    return BASELINE_ATTENTIONS + tuple(
        (f"baseline {', '.join(names)} step self", 12, 64, s, s, b, (0.0, 0.1), True)
        for (b, s), names in by_shape.items())


def baseline_ln_shapes() -> dict:
    """K4's distinct shapes on the baseline's VQA forward (B=1024), CC step
    (B=256) and multi-task iteration (a step of each task it trains), in
    ``ln_shapes()``'s form under BASELINE_LN_PATHS."""
    from vilbert_tpu_torch.core.config import ModelConfig

    cfg = ModelConfig.from_json_file(BASELINE_CONFIG)
    h = cfg.hidden_size
    per_path = {
        "baseline_vqa": [("baseline VQA", baseline_ln_forward(cfg, BASE_VQA_BATCH, T, R))],
        "baseline_cc": [("baseline CC", baseline_ln_forward(
            cfg, TRAIN_BATCH, TRAIN_T, TRAIN_R,
            [(TRAIN_BATCH * LM_GATHER, h), (TRAIN_BATCH * TRAIN_R, h)]))],
        "baseline_multitask": [(f"baseline {key}", baseline_task_ln_shapes({key: task}, cfg))
                               for key, task in baseline_tasks().items()],
    }
    out = {}
    for path, sources in per_path.items():
        for who, shapes in sources:
            for key, n in shapes.items():
                row = out.setdefault(key, {"label": [], **{p: 0 for p in BASELINE_LN_PATHS}})
                row["label"].append(who)
                row[path] += n
    return {key: dict(row, label=" + ".join(row["label"])) for key, row in out.items()}


def phase_baseline_timing(checks: Checks, card: str, err: dict) -> dict:
    """K1 (and K2 where a path trains) at ``baseline_attentions()`` against the
    plain versions (outputs within phase 3's bounds, each call on its
    variant's counter), SDPA and the bound; K4 at ``baseline_ln_shapes``."""
    import torch

    from vilbert_tpu_torch.ops.attention import (
        attention,
        attention_bwd,
        attention_bwd_ref,
        attention_ref,
        bwd_variant,
        fwd_variant,
    )

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    times = {}
    for label, heads, d, sq, sk, B, rates, backward in baseline_attentions():
        q, k, v, cot = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                        for s in (sq, sk, sk, sq))
        mask = torch.ones(B, sk, dtype=torch.long, device=DEVICE)
        mask[:, sk - sk // 4:] = 0
        b = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        cost = attention_cost(B, heads, d, sq, sk)
        fv, bv = fwd_variant(torch.bfloat16, sq, sk, d), bwd_variant(torch.bfloat16, sq, sk, d)
        for rate in rates:
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None)
            with torch.inference_mode():
                got, on_fv = counted(attention, fv, lambda: attention(q, k, v, b, **kw))
                e, bnd, ok = _fwd_error(got, attention_ref(q, k, v, b, **kw), "bfloat16")
                eb, okb, on_bv = 0.0, True, True
                if backward:
                    got, on_bv = counted(attention_bwd, bv,
                                         lambda: attention_bwd(q, k, v, b, cot, **kw))
                    eb, okb = _bwd_errors(got, attention_bwd_ref(q, k, v, b, cot, **kw),
                                          "bfloat16")
            track_error(err, "attention_fwd", fv, e)
            track_error(err, "attention_bwd", bv, eb)
            checks.expect(ok and okb and on_fv and on_bv,
                          f"{label} B={B} bf16 rate {rate} [{fv}, {bv}]: fwd max|err| {e:.3e} "
                          f"(<= {bnd:.3e}), bwd max|err| {eb:.3e}")
            lib = library_attention_fns(q, k, v, b, cot, heads, d) if rate == 0.0 else {}
            fwd, _ = k1_fns(q, k, v, b, kw)
            check_k1_variants(checks, err, fwd, f"{label} B={B} bf16 rate {rate}")
            with torch.inference_mode():
                rows = {"fwd": timed_row({**fwd, **({"library": lib["library"]} if lib else {})},
                                         "kernel", "plain", *cost["fwd"], BF16_TC_FLOPS,
                                         library="library" if lib else None, iters=10)}
            if backward:
                bwd = {**bwd_fns(q, k, v, b, cot, kw), **lib}
                rows["bwd"] = timed_row(
                    bwd, "kernel", "plain", *cost["bwd"], BF16_TC_FLOPS, iters=10,
                    library=(lambda dev: dev["library_fwd_bwd"] - dev["library"]) if lib
                    else None)
            rows["fwd"]["variant"] = fv
            if "bwd" in rows:
                rows["bwd"]["variant"] = bv
            for kind, row in rows.items():
                times[(f"attention_{kind}", label, rate)] = row
                log(f"  attention {kind} {label} B={B} h={heads} d={d} {sq}x{sk} bf16 rate "
                    f"{rate} [{row['variant']}]: {row_text(row)} [{card}]")
    times.update(time_layer_norm(checks, baseline_ln_shapes(), card, err, g,
                                 paths=BASELINE_LN_PATHS))
    checks.end_phase("baseline timing")
    return times


# -- phase 19 ----------------------------------------------------------------

#: static int8 calibrates on one batch of 64 samples, as bench.py:66-78 does
INT8_CALIB_BATCH = 64
VQA_HEAD = ("vil_prediction",)


@contextlib.contextmanager
def recording_int8_sites():
    """Counts the int8 sites' calls by (rows, in, out, x dtype, static)
    while open, through ``int8_dense`` as ``models.layers`` reaches it."""
    from vilbert_tpu_torch.models import layers

    dense, seen = layers.int8_dense, collections.Counter()

    def recorded(x, weight, out_dtype, act_amax=None):
        seen[(x.numel() // x.shape[-1], x.shape[-1], weight.shape[0], str(x.dtype)[6:],
              act_amax is not None)] += 1
        return dense(x, weight, out_dtype, act_amax)

    layers.int8_dense = recorded
    try:
        yield seen
    finally:
        layers.int8_dense = dense


def logit_corr(a, b) -> float:
    import numpy as np

    a, b = (t.float().cpu().numpy().ravel() for t in (a, b))
    return float(np.corrcoef(a, b)[0, 1])


def check_int8_site(checks: Checks, g, rows: int, k: int, n: int, dtype: str,
                    static: bool) -> None:
    """``int8_dense`` at one site shape on the card against its plain
    version (``plain=True``: the product by ``int_mm_ref``): the int32
    products bit-equal, the outputs within fp32 rounding of the largest."""
    import torch

    from vilbert_tpu_torch.ops import quant

    x = (torch.randn(rows, k, generator=g, device=DEVICE) * 2).to(getattr(torch, dtype))
    w = torch.randn(n, k, generator=g, device=DEVICE) * 0.02
    amax = x.float().abs().amax(0) * 0.9 if static else None
    xq, s_in = (quant.quantize_act_static(x, amax) if static else quant.quantize(x, None))
    wq, _ = quant.quantize(w.float() * s_in[None, :] if static else w, 1)
    exact = torch.equal(quant.int_mm(xq, wq), quant.int_mm_ref(xq, wq))
    out_dt = torch.bfloat16
    got, want = (quant.int8_dense(x, w, out_dt, amax, plain=p) for p in (False, True))
    e = float((got.float() - want.float()).abs().max())
    bound = 2.0 ** -23 * float(want.float().abs().max())
    torch.cuda.synchronize()
    checks.expect(exact and e <= bound,
                  f"int8 site {rows}x{k}->{n} {dtype} {'static' if static else 'dynamic'}: "
                  f"int32 product bit-equal {exact}, out max|err| {e:.3e} <= {bound:.3e}")


def time_int8_sites(shapes: dict, card: str, g) -> dict:
    """At each int8 site shape of the VQA forward: the quantization passes
    (dynamic: the activation's per-tensor and the weight's per-channel
    quantize; static: the calibrated activation quantize, the fold and the
    weight quantize; and the weight's share of each alone, which quantized
    weights kept between calls would save), ``int_mm`` (the padding
    included) and ``torch._int_mm`` on operands padded before the timed
    call, ``F.linear`` in bf16 (the bf16 model's product, bias inside) and
    the whole ``int8_dense``."""
    import torch
    import torch.nn.functional as F

    from vilbert_tpu_torch.ops import quant

    rows_out = {}
    for (rows, k, n, dtype, _), count in sorted(shapes.items()):
        x = torch.randn(rows, k, generator=g, device=DEVICE).to(getattr(torch, dtype))
        w = torch.randn(n, k, generator=g, device=DEVICE) * 0.02
        b = torch.zeros(n, device=DEVICE)
        amax = x.float().abs().amax(0)
        xq, _ = quant.quantize(x, None)
        wq, _ = quant.quantize(w, 1)
        pad = (max(rows, quant.INT_MM_MIN_ROWS), -(-k // 8) * 8, -(-n // 8) * 8)
        xp, wp = xq.new_zeros(pad[0], pad[1]), wq.new_zeros(pad[2], pad[1])
        xp[:rows, :k], wp[:n, :k] = xq, wq
        wpt = wp.T
        xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        fns = {
            "quantize_dynamic": lambda: (quant.quantize(x, None), quant.quantize(w, 1)),
            "quantize_static": lambda: (quant.quantize_act_static(x, amax),
                                        quant.quantize(w * (amax / 127.0 + 1e-8)[None, :], 1)),
            "quantize_weight_dynamic": lambda: quant.quantize(w, 1),
            "quantize_weight_static": lambda: quant.quantize(w * (amax / 127.0 + 1e-8)[None, :],
                                                             1),
            "int_mm": lambda: quant.int_mm(xq, wq),
            "int_mm_prepadded": lambda: torch._int_mm(xp, wpt),
            "linear_bf16": lambda: F.linear(xb, wb, bb),
            "int8_dense": lambda: quant.int8_dense(x, w, torch.bfloat16),
        }
        with torch.inference_mode():
            dev = device_ms(fns, iters=10)
        dev["count"] = count
        dev["padded"] = pad != (rows, k, n)
        rows_out[f"{rows}x{k}->{n} {dtype}"] = dev
        log(f"  int8 site {rows}x{k}->{n} {dtype} x{count} a forward: device ms quantize "
            f"{dev['quantize_dynamic']:.4f} dynamic / {dev['quantize_static']:.4f} static (the "
            f"weight's {dev['quantize_weight_dynamic']:.4f} / "
            f"{dev['quantize_weight_static']:.4f}), "
            f"int_mm {dev['int_mm']:.4f}{' (padded)' if dev['padded'] else ''}, _int_mm on "
            f"prepadded operands {dev['int_mm_prepadded']:.4f}, int8_dense "
            f"{dev['int8_dense']:.4f}; bf16 F.linear {dev['linear_bf16']:.4f} [{card}]")
    return rows_out


def phase_int8(checks: Checks, tmp: str, card: str) -> dict:
    """(19) Int8 inference: ``run_eval`` on synthetic TASK1 with the eval
    CLI's ``--int8`` (launches reset just before and read just after:
    ``torch._int_mm`` once a site a forward, K1 and K4 as in phase 4), its
    logits against the bf16 forward's; static int8 calibrated on 64
    samples; every int8 site shape of the VQA forward and the demo through
    ``int8_dense`` (and the head split and merge) against the plain
    versions; questions/s of the bf16, dynamic and static forwards at
    B=1024 with the quantization passes' share; ``demo --int8``."""
    import torch

    from vilbert_tpu_torch.cli import demo
    from vilbert_tpu_torch.cli.eval_tasks import build_model, run_eval, synthetic_vqa_loader
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.ops.quant import calibrating

    cfg = ModelConfig.from_json_file(CONFIG)
    task = task1()
    bf16 = build_model(cfg, seed=SEED, device=DEVICE)
    models = {"bf16": bf16}
    for mode in ("int8_matmul", "int8_static"):
        models[mode] = build_model(cfg.replace(**{mode: True}), seed=SEED, device=DEVICE)
        models[mode].load_state_dict(bf16.state_dict())
    loader = synthetic_vqa_loader(cfg, task)
    n_batches = len(loader)
    sites = sum(1 for name, m in models["int8_matmul"].named_modules()
                if getattr(m, "int8", None) and name.startswith(("bert.", "vil_prediction.")))
    with recording_int8_sites() as seen:
        reset_launches()
        metrics, records = run_eval(models["int8_matmul"], cfg.replace(int8_matmul=True),
                                    {"TASK1": task}, {"TASK1": loader},
                                    output_dir=os.path.join(tmp, "int8"),
                                    split=task.val_split)["TASK1"]
        torch.cuda.synchronize()
        launches = read_launches()
    log(f"  run_eval TASK1 --int8: loss {metrics['loss']:.6f} score {metrics['score']:.6f} "
        f"records {len(records)}; launches {launches}")
    log(f"  torch._int_mm launches in run_eval --int8: {launches['int_mm']} "
        f"({launches['int_mm_padded']} on padded operands; {sites} int8 sites a forward)")
    want_attn, want_ln = kernel_calls_per_forward(cfg)
    checks.expect(launches["int_mm"] == sum(seen.values()) == n_batches * sites
                  and launches["int_mm_padded"] > 0,
                  f"--int8: torch._int_mm launches {launches['int_mm']} == int8 sites called "
                  f"{sum(seen.values())} == {n_batches} x {sites}, some padded "
                  f"({launches['int_mm_padded']})")
    check_k1(checks, f"--int8, {n_batches} x {want_attn}", launches,
             k1_routed(vl_attention_shapes(cfg, T, R), n_batches))
    checks.expect(launches["layer_norm"] == n_batches * want_ln
                  and launches["attention_probs"] == 0,
                  f"--int8: K4 {launches['layer_norm']} == {n_batches} x {want_ln}, no "
                  f"probabilities")
    checks.expect(math.isfinite(metrics["loss"]) and len(records) == metrics["num_samples"],
                  "--int8: loss finite, one record a question")

    # logits against the bf16 forward's; static int8 calibrated on 64 samples
    x = random_batch(cfg, CHECK_BATCH, SEED + 1)
    with torch.inference_mode(), calibrating(models["int8_static"]):
        models["int8_static"](**random_batch(cfg, INT8_CALIB_BATCH, SEED + 30), heads=VQA_HEAD)
    logits = {}
    with torch.inference_mode():
        for name, m in models.items():
            logits[name] = m(**x, heads=VQA_HEAD).vil_prediction
    for mode in ("int8_matmul", "int8_static"):
        corr = logit_corr(logits["bf16"], logits[mode])
        checks.expect(bool(torch.isfinite(logits[mode]).all()) and corr > 0.98,
                      f"B={CHECK_BATCH} {mode} bf16 logits finite, correlation with the bf16 "
                      f"forward's {corr:.5f} > 0.98 (tests/test_quant.py's bound)")

    # every site shape of the VQA forward (B=1024) and of the demo, kernels
    # against plain versions; then the times
    xt = random_batch(cfg, TIME_BATCH, SEED + 2)
    with torch.inference_mode(), recording_int8_sites() as vqa_sites:
        models["int8_matmul"](**xt, heads=VQA_HEAD)
    buf = io.StringIO()
    with recording_int8_sites() as demo_sites, contextlib.redirect_stdout(buf):
        reset_launches()
        out = demo.main(["--synthetic", "--config", CONFIG, "--device", DEVICE, "--int8",
                         "--question", "what color is the couch?"])
        torch.cuda.synchronize()
        demo_launches = read_launches()
    lines = buf.getvalue().strip().splitlines()
    log("  demo --int8: " + " | ".join(lines))
    log(f"  torch._int_mm launches in demo --int8: {demo_launches['int_mm']} "
        f"({demo_launches['int_mm_padded']} padded)")
    checks.expect(len(lines) == 6 and out.vil_prediction.shape == (1, 3129)
                  and all(bool(torch.isfinite(v).all()) for v in out[:-1] if v is not None)
                  and demo_launches["int_mm"] == sum(demo_sites.values()) > 0
                  and demo_launches["attention"] == want_attn,
                  f"demo --int8: six lines, every head finite, torch._int_mm launches "
                  f"{demo_launches['int_mm']} == int8 sites called {sum(demo_sites.values())}, "
                  f"K1 {demo_launches['attention']} == {want_attn}")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    shapes = sorted({key[:4] for key in (*vqa_sites, *demo_sites)})
    for rows, k, n, dtype in shapes:
        for static in (False, True):
            with torch.inference_mode():
                check_int8_site(checks, g, rows, k, n, dtype, static)
    site_times = time_int8_sites(vqa_sites, card, g)

    forward_ms = {}
    for name in ("bf16", "int8_matmul", "int8_static", "int8_static", "int8_matmul", "bf16"):
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: models[name](**xt, heads=VQA_HEAD), iters=4, warmup=1)
        forward_ms.setdefault(name, []).append(ms)
    summary = {"questions_per_s": {}, "quantize_share": {}}
    for name, (a, b) in forward_ms.items():
        ms = (a + b) / 2
        summary["questions_per_s"][name] = TIME_BATCH / ms * 1e3
        mode = {"int8_matmul": "dynamic", "int8_static": "static"}.get(name)
        share = ""
        if mode:
            q_ms, w_ms = (sum(r["count"] * r[key] for r in site_times.values())
                          for key in (f"quantize_{mode}", f"quantize_weight_{mode}"))
            summary["quantize_share"][name] = q_ms / ms
            share = (f"; the quantization passes {q_ms:.2f} ms ({q_ms / ms:.1%}; the weights' "
                     f"{w_ms:.2f} ms), summed over the site shapes' device times")
        log(f"  forward B={TIME_BATCH} T={T} R={R} {name}: {a:.3f} / {b:.3f} ms = "
            f"{summary['questions_per_s'][name]:.1f} questions/s{share} [{card}]")
    summary.update(site_times=site_times, launches=launches, demo_launches=demo_launches)
    del models, bf16
    checks.end_phase("int8")
    return summary


# -- phase 20 ----------------------------------------------------------------

VIS_BATCH = 256
#: K1 with its probabilities output at the other variants' shapes (h, d, Sq,
#: Sk, dtype): long_tc and wg's online branch past 128 keys, wg's exact
#: branch, cc in fp32, at rates 0 and 0.1 (each on its routed variant)
PROBS_EDGE_CASES = [
    (8, 128, 101, 200, "bfloat16"), (12, 64, 257, 306, "bfloat16"), (12, 64, 562, 562, "bfloat16"),
    (8, 128, 1, 129, "bfloat16"), (8, 128, 17, 65, "bfloat16"), (8, 128, 101, 101, "float32"),
    (12, 64, 23, 23, "float32"), (8, 128, 37, 300, "float32"),
]


def phase_visualization(checks: Checks, card: str, err: dict) -> tuple:
    """(20) A VQA forward at B=256 with ``visualization`` (launches reset
    just before and read just after: every K1 launch with its
    probabilities, each on the variant ``fwd_variant`` routes its shape to,
    as without maps): each site's maps against ``attention_ref`` on
    the inputs that site got, element by element (``_probs_error``), and
    its context within phase 3's bounds; the logits bit-equal to the
    forward without maps; K1 with probabilities at every variant (wg,
    long_tc, cc) against the plain version likewise, rates 0 and 0.1; the forward's
    time with and without maps; K1 with probabilities timed at the VQA and
    demo shapes beside its plain version and its bound (the P write
    included)."""
    import torch

    from vilbert_tpu_torch.cli.eval_tasks import build_model
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models import layers
    from vilbert_tpu_torch.ops.attention import attention, attention_ref, fwd_variant

    cfg = ModelConfig.from_json_file(CONFIG)
    model = build_model(cfg, seed=SEED, device=DEVICE)
    vmodel = build_model(cfg.replace(visualization=True), seed=SEED, device=DEVICE)
    x = random_batch(cfg, VIS_BATCH, SEED + 20)
    calls, attend = [], layers.attention

    def recorded(q, k, v, bias, **kw):
        out = attend(q, k, v, bias, **kw)
        calls.append((q, k, v, bias, kw, out))
        return out

    layers.attention = recorded
    try:
        with torch.inference_mode():
            reset_launches()
            out_v = vmodel(**x, heads=VQA_HEAD)
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        layers.attention = attend
    with torch.inference_mode():
        out_p = model(**x, heads=VQA_HEAD)
    want_attn, _ = kernel_calls_per_forward(cfg)
    maps = out_v.attention_probs
    log(f"  visualization forward B={VIS_BATCH}: {len(maps)} maps; launches {launches}")
    want_k1 = k1_routed(vl_attention_shapes(cfg, T, R))
    checks.expect(len(maps) == len(calls) == want_attn
                  and launches["attention"] == launches["attention_probs"] == want_attn
                  and all(launches[name] == n for name, n in want_k1.items()),
                  f"visualization: {len(maps)} maps == {want_attn} sites, K1 launches "
                  f"{launches['attention']} == with probabilities {launches['attention_probs']}, "
                  f"by variant {k1_text(launches, want_k1)}")
    checks.expect(torch.equal(out_v.vil_prediction, out_p.vil_prediction),
                  "visualization: logits bit-equal to the forward without maps")
    worst, worst_ratio, ok = 0.0, 0.0, True
    with torch.inference_mode():
        for q, k, v, bias, kw, (ctx, probs) in calls:
            ref_ctx, ref_p = attention_ref(q, k, v, bias, **kw)
            e, ratio, ok_p = _probs_error(probs, ref_p, "bfloat16", bias)
            _, _, ok_c = _fwd_error(ctx, ref_ctx, "bfloat16")
            worst, worst_ratio = max(worst, e), max(worst_ratio, ratio)
            ok = ok and ok_p and ok_c
            track_error(err, "attention_fwd_probs", "tc", e)
    checks.expect(ok and all(any(m is c[-1][1] for c in calls) for m in maps.values()),
                  f"visualization: every site's maps (the output's) against attention_ref on "
                  f"its inputs, element by element within one bf16 rounding (2^-7 |ref| + "
                  f"2^-8 / Sk): max|err| {worst:.3e}, worst err/bound {worst_ratio:.3f} <= 1; "
                  f"contexts within one rounding of their max")
    del calls

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    for heads, d, sq, sk, dtype in PROBS_EDGE_CASES:
        q, k, v, _, bias = _attention_operands(g, 4, heads, d, sq, sk, getattr(torch, dtype))
        variant = fwd_variant(q.dtype, sq, sk, d)
        for rate in (0.0, 0.1):
            kw = dict(num_heads=heads, dropout_rate=rate, seed=DROPOUT_SEED if rate else None,
                      return_probs=True)
            with torch.inference_mode():
                before = attention.launches_probs
                (ctx, probs), on_variant = counted(attention, variant,
                                                   lambda: attention(q, k, v, bias, **kw))
                launches_probs = attention.launches_probs - before
                ref_ctx, ref_p = attention_ref(q, k, v, bias, **kw)
            e, ratio, ok = _probs_error(probs, ref_p, dtype, bias)
            eo, _, ok_o = _fwd_error(ctx, ref_ctx, dtype)
            track_error(err, "attention_fwd_probs", variant, e)
            checks.expect(ok and ok_o and on_variant and launches_probs == 1,
                          f"attention probabilities h={heads} d={d} Sq={sq} Sk={sk} {dtype} rate "
                          f"{rate} [{variant}]: max|err| {e:.3e}, worst err/bound {ratio:.3f} "
                          f"<= 1 (element by element); output {eo:.3e} (phase 3's bounds)")

    times = {}
    for maps_on in (False, True, True, False):
        m = vmodel if maps_on else model
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: m(**x, heads=VQA_HEAD), iters=6, warmup=1)
        times.setdefault("with maps" if maps_on else "without maps", []).append(ms)
    for label, (a, b) in times.items():
        log(f"  forward B={VIS_BATCH} bf16 {label}: {a:.3f} / {b:.3f} ms = "
            f"{2 * VIS_BATCH / (a + b) * 1e3:.1f} questions/s [{card}]")
    summary = {"forward_ms": {k: sum(v) / 2 for k, v in times.items()}, "launches": launches}
    del model, vmodel

    rows = {}
    mask = torch.ones(VIS_BATCH, R, dtype=torch.long, device=DEVICE)
    mask[:, 60:] = 0
    shapes = [("VQA " + label, heads, d, sq, sk, VIS_BATCH)
              for label, heads, d, sq, sk in VQA_ATTENTIONS]
    shapes += [(label, heads, d, sq, sk, b) for label, heads, d, sq, sk, b in RET_ATTENTIONS
               if label.startswith("demo")]
    for label, heads, d, sq, sk, B in shapes:
        q, k, v = (torch.randn(B, s, heads * d, generator=g, device=DEVICE).bfloat16()
                   for s in (sq, sk, sk))
        bias = ((1.0 - mask[:B, :sk].float()) * -10000.0)[:, None, None, :]
        kw = dict(num_heads=heads, return_probs=True)
        fns = {"kernel": lambda: attention(q, k, v, bias, **kw),
               "plain": lambda: attention_ref(q, k, v, bias, **kw)}
        nbytes, flops = attention_cost(B, heads, d, sq, sk)["fwd"]
        with torch.inference_mode():
            e, ratio, ok = _probs_error(fns["kernel"]()[1], fns["plain"]()[1], "bfloat16", bias)
            row = timed_row(fns, "kernel", "plain", nbytes + 2 * B * heads * sq * sk, flops,
                            BF16_TC_FLOPS, iters=10)
        track_error(err, "attention_fwd_probs", "tc", e)
        checks.expect(ok, f"attention probabilities {label} B={B}: max|err| {e:.3e}, worst "
                          f"err/bound {ratio:.3f} <= 1 (element by element)")
        row["variant"] = fwd_variant(torch.bfloat16, sq, sk, d)
        rows[("attention_fwd_probs", f"{label} B={B}", 0.0)] = row
        log(f"  attention with probabilities {label} B={B} h={heads} d={d} {sq}x{sk} bf16 "
            f"(no library call returns them): {row_text(row)} [{card}]")
    checks.end_phase("visualization")
    return rows, summary


# -- phase 21 ----------------------------------------------------------------

REMAT_STEPS = 2


def phase_remat(checks: Checks, tmp: str, card: str) -> dict:
    """(21) ``train_concap --remat`` at the bench geometry (B=256, T=36,
    R=37, bf16, dropout 0.1) for 2 steps, launches reset just before and
    read just after: K1 twice a step (the forward and the recompute), K2
    once; then one step from the same weights and seed with remat and
    without, loss and every gradient within phase 6's bounds of each other;
    samples/s and peak memory of both on a held batch."""
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config, train
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn, pretrain_model

    args = build_parser().parse_args([
        "--synthetic", "--config", CONFIG, "--remat", "--batch_size", str(TRAIN_BATCH),
        "--num_steps", str(REMAT_STEPS), "--seed", str(SEED), "--device", DEVICE,
        "--output_dir", os.path.join(tmp, "cc_remat"),
    ])
    losses = []
    reset_launches()
    state = train(args, hooks=[lambda step, st, m: losses.append(float(m["loss"]))])
    torch.cuda.synchronize()
    launches = read_launches()
    cfg = state.model.cfg
    per_step = kernel_calls_per_step(cfg)
    encoder_ln = (2 * cfg.num_hidden_layers + 2 * cfg.v_num_hidden_layers
                  + 4 * cfg.num_connection_layers)
    want = {"attention": 2 * per_step["attention"], "attention_bwd": per_step["attention_bwd"],
            "layer_norm": per_step["layer_norm"] + encoder_ln}
    log(f"  train --remat: losses {losses}; launches {launches}")
    checks.expect(cfg.remat and len(losses) == REMAT_STEPS and all(map(math.isfinite, losses)),
                  "--remat: cfg.remat set, losses finite")
    for name, n in want.items():
        checks.expect(launches[name] == REMAT_STEPS * n,
                      f"--remat: {name} launches {launches[name]} == {REMAT_STEPS} x {n} (each "
                      f"encoder block's forward again in the backward)")
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()

    batch = to_device(host_batch(bench_batch(cfg, TRAIN_BATCH, SEED + 22), cfg), DEVICE)
    grads, out = {}, {}
    for remat in (False, True):
        model = pretrain_model(cfg.replace(remat=remat), "vilbert")
        model.load_state_dict(weights)
        model = model.to(DEVICE).train()
        gen = torch.Generator().manual_seed(SEED + 23)
        set_dropout_generator(model, gen)
        loss, _ = make_pretrain_loss_fn(model.cfg, lm_gather=LM_GATHER)(model, batch)
        loss.backward()
        # held on the host, so that the card's peak below is the step's own
        grads[remat] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                        gen.get_state())
        model.zero_grad(set_to_none=True)
        opt, _ = build_optimizer(optimizer_config(args, schedule="constant"),
                                 dict(model.named_parameters()), 1000)
        step = make_train_step(make_pretrain_loss_fn(model.cfg, lm_gather=LM_GATHER), opt)
        step(model, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            metrics = step(model, batch)
        float(metrics["loss"])
        dt = (time.perf_counter() - t0) / 3
        out["remat" if remat else "plain"] = {
            "samples_per_s": TRAIN_BATCH / dt, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  train step B={TRAIN_BATCH} bf16 {'--remat' if remat else 'without remat'}: "
            f"{dt * 1e3:.2f} ms/step = {TRAIN_BATCH / dt:.1f} samples/s, peak memory "
            f"{out['remat' if remat else 'plain']['peak_gb']:.2f} GB [{card}]")
        del model, opt, step
        torch.cuda.empty_cache()
    (lp, gp, sp), (lr, gr, sr) = grads[False], grads[True]
    top = max(float(g.abs().max()) for g in gp.values())
    worst = max(float((gr[n] - gp[n]).abs().max())
                / (1e-3 * float(gp[n].abs().max()) + 1e-6 * top) for n in gp)
    loss_err = abs(lr - lp) / abs(lp)
    checks.expect(loss_err <= 1e-5 and worst <= 1.0 and torch.equal(sp, sr),
                  f"B={TRAIN_BATCH} bf16 step with dropout, remat vs not: loss {lr:.6f} vs "
                  f"{lp:.6f} (rel {loss_err:.3e} <= 1e-5), worst gradient at {worst:.3e} of "
                  f"phase 6's bound (<= 1), the dropout generator in the same state after")
    out["launches"] = launches
    checks.end_phase("remat")
    return out


# -- phases 22-25: staging, data parallelism, the native reader, TF import ------

PREFETCH_WINDOW = (2, 7)    # CC driver: untraced from step 2's hook to step 7's
PREFETCH_PROFILED = 2       # CC driver steps profiled after the window
DP_STEPS = 3                # full-width CC steps of the two-rank check
DP_WORLD = 2
#: the two-rank check's runs: label -> (compute dtype, gradient dtype)
DP_LEGS = {"float32": ("float32", ""), "bf16_grads": ("float32", "bfloat16"),
           "bfloat16": ("bfloat16", "")}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Profiled:
    """``torch.profiler`` (CUDA activity: the device's kernels and copies)
    opened and closed from hooks; the device time of what ran between, in
    ms."""

    def __init__(self):
        self.prof, self.device_ms = None, None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> float:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        self.device_ms = sum(ev.device_time_total for ev in self.prof.events()
                             if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        self.prof = None
        return self.device_ms


def cc_driver(cfg, args, model, make_loader, depth: int) -> dict:
    """``run_pretraining`` over the synthetic CC loader at ``depth``: the
    metrics of every step, samples/s over the untraced window, device ms a
    step over the profiled steps after it, the idle share, the launches."""
    import copy

    import torch

    from vilbert_tpu_torch.cli.train_concap import optimizer_config
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    metrics, marks, prof = [], {}, Profiled()
    first, last = PREFETCH_WINDOW

    def hook(step, state, m):
        metrics.append({k: v.detach() for k, v in m.items()})
        if step + 1 == first:
            torch.cuda.synchronize()
            marks["t0"] = time.perf_counter()
        elif step + 1 == last:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.start()
        elif step + 1 == last + PREFETCH_PROFILED:
            prof.stop()

    reset_launches()
    run_pretraining(cfg, optimizer_config(args, schedule="constant"), make_loader(),
                    num_steps=last + PREFETCH_PROFILED, seed=SEED, lm_gather=LM_GATHER,
                    model=copy.deepcopy(model), device=DEVICE, log_every=0, hooks=[hook],
                    prefetch_batches=depth)
    torch.cuda.synchronize()
    launches = read_launches()
    step_ms = (marks["t1"] - marks["t0"]) / (last - first) * 1e3
    device = prof.device_ms / PREFETCH_PROFILED
    return {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "step_ms": step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
            "device_ms": device, "idle_share": 1.0 - device / step_ms, "launches": launches}


def mt_depth_0(tasks, tmp: str) -> dict:
    """Phase 8's flagship trainer (the CLI's; ``TrainConfig.prefetch_batches``
    2) built again from the same flags, seed and batches, its tasks' staging
    depth set to 0 before their first batch: iterations 0 and 1 (every
    task's loss, against phase 8's), 1 timed, then one more profiled."""
    import torch

    from vilbert_tpu_torch.cli.train_tasks import build_trainer
    from vilbert_tpu_torch.core.config import ModelConfig

    loaders, val_loaders = multitask_loaders(tasks, ModelConfig.from_json_file(CONFIG).vocab_size)
    trainer = build_trainer(multitask_args(os.path.join(tmp, "mt_prefetch_0"), [
        "--num_iterations", str(MT_ITERATIONS)]), tasks, loaders, val_loaders=val_loaders)
    for task in trainer.tasks.values():
        task.prefetch_batches = 0
    losses, prof = [], Profiled()
    reset_launches()
    for it in range(MT_ITERATIONS + 1):
        if it == MT_ITERATIONS - 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if it == MT_ITERATIONS:
            prof.start()
        out = trainer.train_iteration(it)
        if it < MT_ITERATIONS:
            losses.extend((k, m["loss"].detach()) for k, m in out.items())
        if it == MT_ITERATIONS - 1:
            torch.cuda.synchronize()
            iteration_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    launches = read_launches()
    trainer.close()
    return {"losses": [(k, float(v)) for k, v in losses], "iteration_ms": iteration_ms,
            "device_ms": prof.device_ms, "launches": launches}


def check_path_launches(checks: Checks, what: str, launches: dict) -> None:
    """K1, K2 and K4 each launched in a training path's run."""
    for name in ("attention", "attention_bwd", "layer_norm"):
        checks.expect(launches[name] > 0, f"{what}: {name} launches {launches[name]} > 0")


def phase_prefetch(checks: Checks, tmp: str, card: str, held_samples_per_s: float,
                   mt_losses: list, mt_iteration_s: list) -> dict:
    """(22) The staging thread (``device_prefetch``). The CC driver
    (``run_pretraining``, synthetic ``ConceptCapLoader``, B=256, bf16,
    dropout 0.1) for 9 steps at depths 0 and 2 from one model and seed:
    every step's metrics bit-equal, samples/s over 5 untraced steps and the
    idle share (1 - the device time of 2 profiled steps over the untraced
    time) at each; the loader's time to build a batch alone on the main
    thread. The flagship trainer at depth 0 (``mt_depth_0``): its first two
    iterations' task losses bit-equal to phase 8's at depth 2, samples/s of
    an iteration at depth 0 and, at depth 2, phase 9's iterations through
    the host loader; the idle share of each over the device time of one
    depth-0 iteration (the same kernels and copies at either depth)."""
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, concap_loader, synthetic_stores
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.prefetch import repeat_iterator
    from vilbert_tpu_torch.data.tokenization import load_tokenizer
    from vilbert_tpu_torch.train.pretrain import host_batch, pretrain_model

    args = build_parser().parse_args(["--synthetic", "--config", CONFIG, "--batch_size",
                                      str(TRAIN_BATCH), "--seed", str(SEED)])
    cfg = ModelConfig.from_json_file(CONFIG)
    store, captions, _, _ = synthetic_stores(TRAIN_BATCH)
    tokenizer = load_tokenizer(None, cfg.vocab_size)

    def make_loader():  # a fresh loader a run: the loader's epochs advance as it is read
        return concap_loader(store, captions, tokenizer, cfg, args, seed=SEED)

    it = repeat_iterator(make_loader().__iter__)  # one batch an epoch here
    host_batch(next(it), cfg)
    t0 = time.perf_counter()
    for _ in range(3):
        host_batch(next(it), cfg)
    loader_ms = (time.perf_counter() - t0) / 3 * 1e3
    model = pretrain_model(cfg, generator=torch.Generator().manual_seed(SEED))
    cc = {depth: cc_driver(cfg, args, model, make_loader, depth) for depth in (0, 2)}
    del model
    torch.cuda.empty_cache()
    for depth, r in cc.items():
        log(f"  CC driver B={TRAIN_BATCH} bf16, prefetch depth {depth}: {r['step_ms']:.2f} "
            f"ms/step = {r['samples_per_s']:.1f} samples/s, device {r['device_ms']:.2f} ms/step, "
            f"idle share {r['idle_share']:.3f}; step losses "
            f"{[round(m['loss'], 6) for m in r['metrics']]} [{card}]")
    log(f"  the CC loader alone: {loader_ms:.1f} ms a batch of {TRAIN_BATCH} on the main "
        f"thread (ConceptCapLoader + host_batch); phase 7's held-batch step "
        f"{TRAIN_BATCH / held_samples_per_s * 1e3:.2f} ms ({held_samples_per_s:.1f} samples/s)"
        f" against the depth-2 driver's {cc[2]['step_ms']:.2f} [{card}]")
    checks.expect(len(cc[0]["metrics"]) == PREFETCH_WINDOW[1] + PREFETCH_PROFILED
                  and cc[0]["metrics"] == cc[2]["metrics"] and all(
                      math.isfinite(v) for m in cc[0]["metrics"] for v in m.values()),
                  "CC driver: every step's metrics finite and bit-equal at depths 0 and 2")
    for depth, r in cc.items():
        check_path_launches(checks, f"CC driver at depth {depth}", r["launches"])

    tasks = flagship_tasks()
    zero = mt_depth_0(tasks, tmp)
    torch.cuda.empty_cache()
    samples = sum(t.batch_size for t in tasks.values())
    two_ms = sum(mt_iteration_s) / len(mt_iteration_s) * 1e3
    mt = {0: {"iteration_ms": zero["iteration_ms"]}, 2: {"iteration_ms": two_ms}}
    for depth, r in mt.items():
        r["samples_per_s"] = samples / r["iteration_ms"] * 1e3
        r["device_ms"] = zero["device_ms"]
        r["idle_share"] = 1.0 - zero["device_ms"] / r["iteration_ms"]
        log(f"  flagship iteration, prefetch_batches {depth}: {r['iteration_ms']:.1f} ms = "
            f"{r['samples_per_s']:.1f} samples/s, idle share {r['idle_share']:.3f} over "
            f"{zero['device_ms']:.1f} ms of device time (a depth-0 iteration, profiled)"
            f"{'' if depth == 0 else '; phase 9, untraced'} [{card}]")
    want = [(k, loss) for k, loss, _ in mt_losses]
    checks.expect(len(zero["losses"]) == MT_ITERATIONS * len(tasks) and zero["losses"] == want
                  and all(math.isfinite(v) for _, v in want),
                  f"flagship trainer at prefetch_batches 0: {MT_ITERATIONS} iterations' task "
                  "losses finite and bit-equal to phase 8's at prefetch_batches 2")
    check_path_launches(checks, "flagship iterations at depth 0", zero["launches"])
    checks.end_phase("prefetch")
    strip = ("metrics", "launches")
    return {"cc": {d: {k: v for k, v in r.items() if k not in strip} for d, r in cc.items()},
            "multitask": mt, "loader_ms": loader_ms,
            "launches": {"cc_train_prefetch_0": cc[0]["launches"],
                         "cc_train_prefetch_2": cc[2]["launches"],
                         "multitask_prefetch_0": zero["launches"]}}


def phase_nccl_one_rank(checks: Checks, tmp: str, card: str, mt_losses: list) -> dict:
    """(23a) One rank over NCCL: ``train_concap.train`` (3 CC steps, B=256,
    bf16, dropout 0.1) with ``--coordinator --num_processes 1 --process_id
    0`` against the same run without a process group, and ``train_tasks``
    (two flagship iterations) with them against phase 8's run without one:
    every loss bit-equal (the step's all-reduce of the gradients and
    metrics over one rank is exact)."""
    import torch
    import torch.distributed as dist

    from vilbert_tpu_torch.cli import train_concap, train_tasks
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.parallel.distributed import is_initialized, shutdown_distributed

    group = ["--coordinator", f"localhost:{free_port()}", "--num_processes", "1",
             "--process_id", "0"]
    cc_args = ["--synthetic", "--config", CONFIG, "--batch_size", str(TRAIN_BATCH),
               "--num_steps", "3", "--seed", str(SEED), "--device", DEVICE]
    tasks = flagship_tasks()
    loaders, val_loaders = multitask_loaders(
        tasks, ModelConfig.from_json_file(CONFIG).vocab_size)
    runs, launches = {}, {}

    def cc_run(label, extra):
        losses = []
        reset_launches()
        train_concap.train(train_concap.build_parser().parse_args(
            cc_args + extra + ["--output_dir", os.path.join(tmp, f"cc_{label}")]),
            hooks=[lambda s, st, m: losses.append({k: float(v) for k, v in m.items()})])
        torch.cuda.synchronize()
        launches[f"cc_train_{label}"] = read_launches()
        runs[f"cc {label}"] = losses

    cc_run("no_group", [])
    cc_run("nccl_one_rank", group)
    backend = dist.get_backend() if is_initialized() else None
    world = dist.get_world_size() if is_initialized() else None
    losses = []
    reset_launches()
    trainer = train_tasks.train(
        multitask_args(os.path.join(tmp, "mt_nccl_one_rank"),
                       ["--num_iterations", str(MT_ITERATIONS), *group]),
        tasks, loaders, val_loaders=val_loaders,
        task_hooks=[lambda key, model, m: m is not None and losses.append(
            (key, float(m["loss"])))])
    torch.cuda.synchronize()
    launches["multitask_nccl_one_rank"] = read_launches()
    trainer.close()
    del trainer
    shutdown_distributed()
    torch.cuda.empty_cache()
    runs["multitask nccl_one_rank"] = losses
    runs["multitask no_group (phase 8)"] = [(k, loss) for k, loss, _ in mt_losses]
    for label, r in runs.items():
        log(f"  {label}: losses {r}")
    checks.expect(backend == "nccl" and world == 1 and not is_initialized(),
                  f"process group: backend {backend}, world size {world}; left after the runs")
    checks.expect(len(runs["cc no_group"]) == 3
                  and runs["cc nccl_one_rank"] == runs["cc no_group"],
                  "train_concap with --coordinator (NCCL, one rank): every step's metrics "
                  "bit-equal to the run without a process group")
    checks.expect(len(losses) == MT_ITERATIONS * len(tasks)
                  and losses == runs["multitask no_group (phase 8)"],
                  f"train_tasks with --coordinator (NCCL, one rank): every task's loss of "
                  f"{MT_ITERATIONS} iterations bit-equal to phase 8's run without a process group")
    for label in ("cc_train_nccl_one_rank", "multitask_nccl_one_rank"):
        check_path_launches(checks, label, launches[label])
    checks.end_phase("NCCL one rank")
    return {"launches": {k: v for k, v in launches.items() if "nccl" in k}}


def dp_runs(mesh, rows) -> dict:
    """The two-rank check's runs (``DP_LEGS``), on this process's ``rows``
    of each global batch (B=256): ``DP_STEPS`` full-width CC steps with
    dropout 0.1 a leg, the metrics, a digest of the parameters after the
    steps, the launches, the first step's gradients as the optimizer
    takes them (averaged over the ranks) and the fp32 leg's parameters
    after the steps."""
    import hashlib

    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.train import optim
    from vilbert_tpu_torch.train.pretrain import pretrain_model, run_pretraining

    grads = []
    step = optim.ReferenceAdamW.step

    def recording(self, g, **kw):
        if not grads:
            grads.append(({k: v.detach().float().cpu() for k, v in g.items()},
                          sorted({str(v.dtype) for v in g.values()})))
        return step(self, g, **kw)

    optim.ReferenceAdamW.step = recording
    args = build_parser().parse_args(["--synthetic", "--config", CONFIG])
    out = {"grads": {}}
    try:
        for leg, (dtype, grad_dtype) in DP_LEGS.items():
            # the model computes in its own config's dtype: one model a leg
            cfg = ModelConfig.from_json_file(CONFIG).replace(compute_dtype=dtype)
            model = pretrain_model(cfg, generator=torch.Generator().manual_seed(SEED))
            loader = [{k: v[rows] for k, v in bench_batch(cfg, TRAIN_BATCH, SEED + 60 + s).items()}
                      for s in range(DP_STEPS)]
            metrics = []
            grads.clear()
            reset_launches()
            state = run_pretraining(
                cfg, optimizer_config(args, schedule="constant"), loader, num_steps=DP_STEPS,
                seed=SEED, lm_gather=LM_GATHER, model=model, device=DEVICE,
                log_every=0, mesh=mesh, grad_dtype=grad_dtype,
                hooks=[lambda s, st, m: metrics.append({k: float(v) for k, v in m.items()})])
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for v in state.model.state_dict().values():
                digest.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
            out[leg] = {"metrics": metrics, "params_sha256": digest.hexdigest(),
                        "launches": read_launches(), "grad_dtypes": grads[0][1]}
            if leg != "bfloat16":
                out["grads"][leg] = grads[0][0]
            if leg == "float32":
                out["params"] = {k: v.detach().cpu() for k, v in state.model.named_parameters()}
            del state, model
            torch.cuda.empty_cache()
    finally:
        optim.ReferenceAdamW.step = step
    return out


def dp_worker(rank: int, port: int, out_dir: str) -> int:
    """A rank of phase 23b, in its own process: gloo over CUDA tensors (two
    ranks share the one card, which NCCL refuses), rows rank * 128 ... of
    each global batch."""
    import torch

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed
    from vilbert_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    device = initialize_distributed(f"localhost:{port}", DP_WORLD, rank, device=DEVICE,
                                    backend="gloo")
    mesh = make_mesh(device=device)
    local = TRAIN_BATCH // DP_WORLD
    result = dp_runs(mesh, slice(rank * local, (rank + 1) * local))
    saved = {"grads": result.pop("grads"), "params": result.pop("params")}
    if rank == 0:
        torch.save(saved, os.path.join(out_dir, "grads_rank0.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    shutdown_distributed()
    return 0


def grad_ratio(got: dict, want: dict, bound) -> dict:
    """name -> max|got - want| over ``bound(want tensor)`` plus 1e-6 of the
    largest gradient of the model (the floor of phases 6 and 11)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: float((got[n] - want[n]).abs().max()) / (bound(want[n]) + 1e-6 * top)
            for n in want}


def param_drift(got: dict, want: dict, steps: int) -> dict:
    """The fp32 parameters ``got`` after ``steps`` steps against one
    process's ``want``: the elements beyond 1e-5 of their tensor's max
    (``beyond`` of ``elements``), how far past it at most in units of 5% of
    lr x steps (``worst``), and per tensor its largest distance over 1e-5
    of its max plus 5% of lr x steps (``ratio``, the bound of phase 26).
    Adam moves an element by lr * m / (sqrt(v) + eps), eps 1e-8: where the
    gradient is near eps (the attention key biases, whose gradient is
    rounding noise; any element whose gradient cancels) the step follows
    the gradient's last bits, so the 5% of lr x steps."""
    slack = 0.05 * optimizer_lr() * steps
    beyond, worst, ratio = 0, 0.0, {}
    for n, w in want.items():
        err = (got[n] - w).abs()
        strict = 1e-5 * float(w.abs().max())
        beyond += int((err > strict).sum())
        ratio[n] = float(err.max()) / (strict + slack)
        worst = max(worst, float((err - strict).max()) / slack)
    return {"beyond": beyond, "elements": sum(w.numel() for w in want.values()),
            "worst": worst, "ratio": ratio}


def phase_two_ranks(checks: Checks, tmp: str, card: str) -> dict:
    """(23b) Two ranks in two processes on the one card over gloo (CUDA
    tensors), 3 full-width CC steps at B_local=128 with dropout 0.1 a leg,
    against one process on the concatenated B=256 batches, run meanwhile in
    this process: fp32 (every step's metrics within 1e-5, the first step's
    gradients within phase 6's bound; the parameters' distance from one
    process's read as phase 26 reads it, ``param_drift``, with no model
    axis), fp32 compute with bf16 gradients, all-reduced in bf16 (the
    first step's bf16 gradients within phase 11's bf16-gradient bound,
    every step's loss within phase 3's bf16 bound) and
    bf16 compute (every step's loss within that bound; every K1, K2 and K4
    launched as the config says); the ranks' metrics and parameters
    bit-equal after every leg. A rank that fails fails the phase."""
    import torch

    out_dir = os.path.join(tmp, "two_ranks")
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp_worker",
                               str(rank), str(port), out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(DP_WORLD)]
    logs = []
    try:
        ref = dp_runs(None, slice(None))
        ref_s = time.time() - t0
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ranks_s = time.time() - t0
    torch.cuda.empty_cache()
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        checks.expect(proc.returncode == 0, f"rank {rank} exited {proc.returncode}")
        if proc.returncode != 0:
            log(text[-4000:])
    checks.end_phase("two ranks (processes)")
    ranks = []
    for rank in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    for leg in DP_LEGS:
        log(f"  {leg}: rank 0 {[round(m['loss'], 6) for m in ranks[0][leg]['metrics']]}, "
            f"rank 1 {[round(m['loss'], 6) for m in ranks[1][leg]['metrics']]}, one "
            f"process {[round(m['loss'], 6) for m in ref[leg]['metrics']]}")
    log(f"  two ranks in {ranks_s:.1f} s (start-up, models, gloo over the host included), "
        f"the one-process reference beside them in {ref_s:.1f} s [{card}]")
    same = all(ranks[0][leg]["metrics"] == ranks[1][leg]["metrics"]
               and ranks[0][leg]["params_sha256"] == ranks[1][leg]["params_sha256"]
               for leg in DP_LEGS)
    checks.expect(same, "the two ranks' metrics and parameters (sha256) bit-equal after "
                        f"{DP_STEPS} steps, every leg")
    worst = max(abs(g[k] - w[k]) / abs(w[k])
                for g, w in zip(ranks[0]["float32"]["metrics"], ref["float32"]["metrics"])
                for k in ("loss", "masked_loss_t", "masked_loss_v", "next_sentence_loss"))
    checks.expect(len(ranks[0]["float32"]["metrics"]) == DP_STEPS and worst <= 1e-5,
                  f"fp32: every step's losses within 1e-5 of one process on B={TRAIN_BATCH} "
                  f"(worst rel {worst:.3e})")
    saved = torch.load(os.path.join(out_dir, "grads_rank0.pt"))
    got = saved["grads"]
    bounds = {"float32": lambda w: 1e-3 * float(w.abs().max()),
              "bf16_grads": lambda w: bf16_bound(w)}
    for leg, bound in bounds.items():
        want = ref["grads"][leg]
        ratio = grad_ratio(got[leg], want, bound) if set(got[leg]) == set(want) else {"": 2.0}
        log(f"  {leg} first-step gradients, the five furthest from one process's (at their "
            "bound; max|grad|): " + ", ".join(
                f"{n} {ratio[n]:.3e} ({float(want[n].abs().max()):.3e})"
                for n in sorted(ratio, key=ratio.get)[-5:] if n in want))
        checks.expect(max(ratio.values()) <= 1.0,
                      f"{leg}: the first step's averaged gradients ({ranks[0][leg]['grad_dtypes']}) "
                      f"against one process's, worst at {max(ratio.values()):.3e} of "
                      f"{'phase 6' if leg == 'float32' else 'phase 11'}'s bound (<= 1)")
    drift = param_drift(saved["params"], ref.pop("params"), DP_STEPS)
    log(f"  float32 parameters after the steps, read as phase 26 reads them (no model axis): "
        f"{drift['beyond']} of {drift['elements']} elements beyond 1e-5 of their tensor's max "
        f"of one process's; beyond it by at most {drift['worst']:.3e} of 5% of lr x steps; "
        f"worst tensor at {max(drift['ratio'].values()):.3e} of 1e-5 of its max plus 5% of "
        f"lr x steps [{card}]")
    del saved
    checks.expect(ranks[0]["bf16_grads"]["grad_dtypes"] == ["torch.bfloat16"],
                  f"bf16_grads: the optimizer takes bf16 gradients "
                  f"({ranks[0]['bf16_grads']['grad_dtypes']}), all-reduced in bf16")
    for leg in ("bf16_grads", "bfloat16"):
        ok = all(abs(g["loss"] - w["loss"]) <= bf16_bound(torch.tensor(w["loss"]))
                 for g, w in zip(ranks[0][leg]["metrics"], ref[leg]["metrics"]))
        checks.expect(len(ranks[0][leg]["metrics"]) == DP_STEPS and ok,
                      f"{leg}: every step's loss within phase 3's bf16 bound of one process's")
    from vilbert_tpu_torch.core.config import ModelConfig

    per_step = kernel_calls_per_step(ModelConfig.from_json_file(CONFIG))
    for name, n in per_step.items():
        got_n = ranks[0]["bfloat16"]["launches"][name]
        checks.expect(got_n == DP_STEPS * n, f"rank 0's bf16 steps: {name} launches {got_n} "
                                              f"== {DP_STEPS} x {n}")
    checks.end_phase("two ranks")
    return {"launches": {"cc_train_two_ranks_rank0": ranks[0]["bfloat16"]["launches"]}}


# -- phase 26: the model axis and in_batch_pairs across ranks ----------------

GRID_SHAPE = (2, 2)         # (data, model) of phase 26a's four processes
GRID_BATCH = 64             # global rows of a step: 32 a data row
GRID_STEPS = 2
GRID_LEGS = ("float32", "bfloat16")
PAIRS_RANKS = 2
PAIRS_LOCAL = 8             # texts and images a rank: 8 x 16 of the 256 pairs


def optimizer_lr() -> float:
    """The CC CLI's learning rate, which phases 23b and 26 train at."""
    from vilbert_tpu_torch.cli.train_concap import build_parser

    return build_parser().parse_args(["--synthetic", "--config", CONFIG]).learning_rate


def digest(tensors) -> str:
    import hashlib

    import torch

    h = hashlib.sha256()
    for v in tensors:
        h.update(v.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def grid_runs(mesh, rows, out_dir: str = "") -> dict:
    """Phase 26a's runs on this process's ``rows`` of each global batch
    (B=64): ``GRID_STEPS`` full-width CC steps with dropout 0.1 a leg (fp32,
    bf16 compute), the update sharded over ``mesh``'s model axis by
    ``param_sharding_rules`` at its default 2^20 (``mesh`` None: one
    process, replicated). Per leg: the metrics, a digest of the parameters,
    the launches, the moments' elements and bytes. The fp32 leg of rank 0
    also feeds the optimizer's gradients to a replicated twin optimizer and
    holds the sharded update to the twin's, bit for bit, every step; it
    writes the first step's gradients, the final parameters, its slices
    and their values before the last step into ``out_dir`` (the one
    process returns the gradients and parameters)."""
    import torch

    from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config
    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.data.prefetch import to_device
    from vilbert_tpu_torch.models.layers import set_dropout_generator
    from vilbert_tpu_torch.parallel.mesh import param_sharding_rules
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn, pretrain_model

    opt_cfg = optimizer_config(build_parser().parse_args(["--synthetic", "--config", CONFIG]),
                               schedule="constant")
    primary = mesh is None or mesh.is_primary
    out = {}
    for leg in GRID_LEGS:
        cfg = ModelConfig.from_json_file(CONFIG).replace(compute_dtype=leg)
        generator = torch.Generator().manual_seed(SEED)
        model = pretrain_model(cfg, generator=generator).to(DEVICE)
        set_dropout_generator(model, generator, rank=mesh.data_rank if mesh else 0)
        params = dict(model.named_parameters())
        opt, _ = build_optimizer(opt_cfg, params, GRID_STEPS, step_offset=1)
        if mesh is not None:
            mesh.replicate(model)  # the optimizer's state is zeros on every rank
        twin, grads, twin_equal = None, [], []
        if leg == "float32" and mesh is not None and primary:
            twin, _ = build_optimizer(opt_cfg, {n: p.detach().clone() for n, p in params.items()},
                                      GRID_STEPS, step_offset=1)
        sharded_step = opt.step

        def recording_step(g, **kw):
            if leg == "float32" and not grads:
                grads.append({k: v.detach().float().cpu() for k, v in g.items()})
            if twin is not None:
                twin.step(g, **kw)
            return sharded_step(g, **kw)

        opt.step = recording_step
        step_fn = make_train_step(
            make_pretrain_loss_fn(cfg, lm_gather=LM_GATHER, mesh=mesh), opt, mesh=mesh,
            shard_rules=param_sharding_rules(model, mesh) if mesh is not None else None)
        batches = [{k: v[rows] for k, v in bench_batch(cfg, GRID_BATCH, SEED + 80 + s).items()}
                   for s in range(GRID_STEPS)]
        metrics, before_last = [], {}
        reset_launches()
        for i, b in enumerate(batches):
            if twin is not None and i == len(batches) - 1:
                before_last = {n: opt.params[n].detach().cpu().clone() for n in opt.shards}
            metrics.append({k: float(v) for k, v in step_fn(model, to_device(
                host_batch(b, cfg), DEVICE)).items()})
            if twin is not None:
                twin_equal.append(all(torch.equal(twin.params[n], p) for n, p in params.items()))
        torch.cuda.synchronize()
        moments = list(opt.state.mu.values()) + list(opt.state.nu.values())
        out[leg] = {"metrics": metrics, "params_sha256": digest(params.values()),
                    "launches": read_launches(), "twin_equal": twin_equal,
                    "moment_elements": sum(m.numel() for m in moments),
                    "moment_bytes": sum(m.numel() * m.element_size() for m in moments),
                    "shards": len(getattr(opt, "shards", {})),
                    "share_elements": 2 * sum(
                        p.numel() // (mesh.model_size if n in getattr(opt, "shards", {}) else 1)
                        for n, p in params.items())}
        if leg == "float32" and primary:
            final = {n: p.detach().cpu() for n, p in params.items()}
            if mesh is None:
                out["grads"], out["params"] = grads[0], final
            else:
                torch.save({"grads": grads[0], "params": final, "shards": dict(opt.shards),
                            "before_last": before_last},
                           os.path.join(out_dir, "grid_rank0.pt"))
        del model, params, opt, twin, step_fn
        torch.cuda.empty_cache()
    return out


def pairs_run(mesh, out_dir: str = "") -> dict:
    """Phase 26b on this process: the full-width encoder (``BertModel``,
    fp32, eval) under ``in_batch_pairs`` over 16 texts and 16 images (seed
    0), of which a rank of ``mesh`` takes its 8 texts and 8 images, forward
    and backward: the loss is the mean over its pair rows of the outputs'
    products with seeded cotangents of the 256 global rows, the gradients
    are averaged over the ranks. Returns the launches, and the outputs and
    gradients (a rank writes them into ``out_dir``)."""
    import torch

    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.models.vilbert import set_pair_mesh
    from vilbert_tpu_torch.parallel.distributed import all_mean_
    from vilbert_tpu_torch.train.pretrain import pretrain_model

    cfg = ModelConfig.from_json_file(CONFIG).replace(compute_dtype="float32",
                                                     in_batch_pairs=True)
    model = set_pair_mesh(pretrain_model(cfg, generator=torch.Generator().manual_seed(SEED))
                          .bert.to(DEVICE).eval(), mesh)
    b = PAIRS_RANKS * PAIRS_LOCAL
    rows = slice(mesh.data_rank * PAIRS_LOCAL, (mesh.data_rank + 1) * PAIRS_LOCAL) if mesh \
        else slice(None)
    batch = {k: torch.from_numpy(v[rows]).to(DEVICE) for k, v in bench_batch(cfg, b, SEED).items()}
    reset_launches()
    out = model(batch["input_ids"], batch["image_feat"], batch["image_loc"],
                batch["segment_ids"], batch["input_mask"], batch["image_mask"])[:4]
    n = out[0].shape[0]
    first = mesh.data_rank * n if mesh else 0
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    loss = sum((o * torch.randn((b * b,) + o.shape[1:], generator=g, device=DEVICE)[
        first:first + n]).sum() for o in out) / n
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    if mesh is not None:
        all_mean_(list(grads.values()), group=mesh.data_group)
    torch.cuda.synchronize()
    launches = read_launches()
    result = {"outputs": [o.detach().cpu() for o in out], "rows": n}
    if mesh is None or mesh.data_rank == 0:
        result["grads"] = {k: v.cpu() for k, v in grads.items()}
    if mesh is not None:
        torch.save(result, os.path.join(out_dir, f"pairs_rank{mesh.data_rank}.pt"))
        return {"launches": launches, "rows": n}
    return {"launches": launches, **result}


def rank_worker(kind: str, rank: int, port: int, out_dir: str) -> int:
    """A rank of phase 26, in its own process: gloo over CUDA tensors (the
    ranks share the one card, which NCCL refuses). "grid": rank r of the
    2 x 2 mesh at (r // 2, r % 2), rows d * 32 ... of each global batch;
    "pairs": rank r of two data ranks."""
    import torch

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed
    from vilbert_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    world = math.prod(GRID_SHAPE) if kind == "grid" else PAIRS_RANKS
    device = initialize_distributed(f"localhost:{port}", world, rank, device=DEVICE,
                                    backend="gloo")
    if kind == "grid":
        mesh = make_mesh(GRID_SHAPE, ("data", "model"), device=device)
        local = GRID_BATCH // mesh.data_size
        result = grid_runs(mesh, slice(mesh.data_rank * local, (mesh.data_rank + 1) * local),
                           out_dir)
    else:
        mesh = make_mesh(device=device)
        result = pairs_run(mesh, out_dir)
    result["mesh"] = [mesh.data_rank, mesh.model_rank]
    with open(os.path.join(out_dir, f"{kind}{rank}.json"), "w") as f:
        json.dump(result, f)
    shutdown_distributed()
    return 0


def start_ranks(kind: str, n: int, out_dir: str) -> list:
    port = free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank_worker", kind,
                              str(rank), str(port), out_dir],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(n)]


def join_ranks(checks: Checks, kind: str, procs: list, out_dir: str) -> list:
    """Wait for the ranks; a rank that failed fails the phase. Their
    results, by rank."""
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        checks.expect(proc.returncode == 0, f"{kind} rank {rank} exited {proc.returncode}")
        if proc.returncode != 0:
            log(text[-4000:])
    checks.end_phase(f"{kind} ranks (processes)")
    results = []
    for rank in range(len(procs)):
        with open(os.path.join(out_dir, f"{kind}{rank}.json")) as f:
            results.append(json.load(f))
    return results


def phase_model_axis(checks: Checks, tmp: str, card: str) -> dict:
    """(26) The model axis and in_batch_pairs across ranks, as processes on
    the one card over gloo (CUDA tensors), each against one process run
    meanwhile in this process.

    (a) A 2 x 2 (data, model) mesh of four processes, ``GRID_STEPS``
    full-width CC steps at B=64 (32 a data row), dropout 0.1, the update
    sharded over "model" by ``param_sharding_rules``. fp32: every step's
    losses within 1e-5 of one process on B=64, the first step's averaged
    gradients within phase 6's bound, the parameters after the steps
    within 1e-5 of each tensor's max plus 5% of lr x steps (Adam's step of
    an element whose gradient is near eps follows its last bits: the
    attention key biases, whose gradient is rounding noise, and elements
    whose gradient cancels), those beyond 1e-5 alone counted, and a
    control beyond that bound: rank 0's slice of each sharded parameter in
    turn left as it was before the last step; rank 0's sharded update
    bit-equal to a replicated optimizer's update of the same gradients,
    every step.
    bf16: every loss within phase 3's bf16 bound of one process's, K1, K2
    and K4 launched as ``kernel_calls_per_step`` says. On every rank the
    moments hold exactly its share of the elements (printed as bytes beside
    the replicated state's); the ranks of a model group, and here all four,
    end with bit-equal parameters.

    (b) ``in_batch_pairs`` over two data ranks: the fp32 encoder at 8 texts
    and 8 images a rank (the global batch's 256 pairs), forward and
    backward: each rank's 128 pair rows within 1e-4 of its rows of one
    process's output on the 16, the averaged gradients within 1e-4 of each
    max of the one process's gradients, plus phase 6's floor of 1e-6 of the
    largest (the key biases' gradients are rounding noise)."""
    import torch

    from vilbert_tpu_torch.core.config import ModelConfig

    out_dir = os.path.join(tmp, "model_axis")
    os.makedirs(out_dir)
    t0 = time.time()
    procs = start_ranks("grid", math.prod(GRID_SHAPE), out_dir)
    try:
        ref = grid_runs(None, slice(None))
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    ranks = join_ranks(checks, "grid", procs, out_dir)
    grid_s = time.time() - t0
    torch.cuda.empty_cache()
    for leg in GRID_LEGS:
        log(f"  (a) {leg}: " + ", ".join(
            f"rank {r} {[round(m['loss'], 6) for m in res[leg]['metrics']]}"
            for r, res in enumerate(ranks))
            + f", one process {[round(m['loss'], 6) for m in ref[leg]['metrics']]}")
    replicated = ref["float32"]["moment_bytes"]
    log(f"  (a) moment bytes a rank (fp32 mu + nu): "
        f"{[res['float32']['moment_bytes'] for res in ranks]} against {replicated} replicated "
        f"({replicated / 1e9:.3f} GB); {ranks[0]['float32']['shards']} sharded parameters "
        f"[{card}]")
    checks.expect([res["mesh"] for res in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]],
                  f"rank r at (r // 2, r % 2): {[res['mesh'] for res in ranks]}")
    for leg in GRID_LEGS:
        shas = {res[leg]["params_sha256"] for res in ranks}
        checks.expect(len(shas) == 1 and all(res[leg]["metrics"] == ranks[0][leg]["metrics"]
                                             for res in ranks),
                      f"{leg}: the four ranks' metrics and parameters (sha256) bit-equal "
                      f"after {GRID_STEPS} steps")
        checks.expect(all(res[leg]["moment_elements"] == res[leg]["share_elements"]
                          < ref[leg]["moment_elements"] for res in ranks),
                      f"{leg}: every rank's moments hold its share "
                      f"({[res[leg]['moment_elements'] for res in ranks]} elements, "
                      f"{ref[leg]['moment_elements']} replicated)")
    checks.expect(ranks[0]["float32"]["twin_equal"] == [True] * GRID_STEPS,
                  f"fp32: rank 0's sharded update bit-equal to a replicated optimizer's on the "
                  f"same gradients, every step ({ranks[0]['float32']['twin_equal']})")
    worst = max(abs(g[k] - w[k]) / abs(w[k])
                for g, w in zip(ranks[0]["float32"]["metrics"], ref["float32"]["metrics"])
                for k in ("loss", "masked_loss_t", "masked_loss_v", "next_sentence_loss"))
    checks.expect(len(ranks[0]["float32"]["metrics"]) == GRID_STEPS and worst <= 1e-5,
                  f"fp32: every step's losses within 1e-5 of one process on B={GRID_BATCH} "
                  f"(worst rel {worst:.3e})")
    saved = torch.load(os.path.join(out_dir, "grid_rank0.pt"))
    ratio = grad_ratio(saved["grads"], ref["grads"], lambda w: 1e-3 * float(w.abs().max()))
    log("  (a) fp32 first-step gradients, the five furthest from one process's (at phase 6's "
        "bound): " + ", ".join(f"{n} {ratio[n]:.3e}" for n in sorted(ratio, key=ratio.get)[-5:]))
    checks.expect(max(ratio.values()) <= 1.0, f"fp32: the first step's averaged gradients within "
                                              f"phase 6's bound (worst {max(ratio.values()):.3e})")
    drift = param_drift(saved["params"], ref["params"], GRID_STEPS)
    ratio = drift["ratio"]
    log(f"  (a) fp32 parameters after the steps: {drift['beyond']} of {drift['elements']} "
        f"elements beyond 1e-5 of their tensor's max of one process's; beyond it by at most "
        f"{drift['worst']:.3e} of 5% of lr x steps; the five tensors furthest: " + ", ".join(
            f"{n} {ratio[n]:.3e}" for n in sorted(ratio, key=ratio.get)[-5:]))
    checks.expect(max(ratio.values()) <= 1.0,
                  f"fp32: every parameter after {GRID_STEPS} steps within 1e-5 of its tensor's max "
                  f"plus 5% of lr x steps of one process's (worst {max(ratio.values()):.3e})")
    # the control: a fault of the sharded update, rank 0's slice of one
    # parameter left as it was before the last step (its update skipped
    # once), read by the same bound, for each sharded parameter alone
    control = {}
    for n, (dim, index, parts) in saved["shards"].items():
        faulty = saved["params"][n].clone()
        size = faulty.shape[dim] // parts
        faulty.narrow(dim, index * size, size).copy_(saved["before_last"][n])
        control[n] = param_drift({n: faulty}, {n: ref["params"][n]}, GRID_STEPS)["ratio"][n]
    least = min(control, key=control.get)
    log(f"  (a) control, rank 0's slice of one sharded parameter not updated in the last step: "
        f"read at {control[least]:.3e} of the bound at least ({least}), median "
        f"{sorted(control.values())[len(control) // 2]:.3e}, over the {len(control)} sharded "
        f"parameters each alone; the sound run at most {max(ratio.values()):.3e}")
    checks.expect(len(control) == ranks[0]["float32"]["shards"] and control[least] > 1.0,
                  f"fp32: the bound catches rank 0's slice of any one sharded parameter left "
                  f"un-updated for one step (least {control[least]:.3e} > 1)")
    ok = all(abs(g["loss"] - w["loss"]) <= bf16_bound(torch.tensor(w["loss"]))
             for g, w in zip(ranks[0]["bfloat16"]["metrics"], ref["bfloat16"]["metrics"]))
    checks.expect(len(ranks[0]["bfloat16"]["metrics"]) == GRID_STEPS and ok,
                  "bf16: every step's loss within phase 3's bf16 bound of one process's")
    per_step = kernel_calls_per_step(ModelConfig.from_json_file(CONFIG))
    for name, n in per_step.items():
        got_n = ranks[0]["bfloat16"]["launches"][name]
        checks.expect(got_n == GRID_STEPS * n,
                      f"rank 0's bf16 steps: {name} launches {got_n} == {GRID_STEPS} x {n}")
    del saved, ref
    torch.cuda.empty_cache()
    checks.end_phase("model axis")

    t1 = time.time()
    procs = start_ranks("pairs", PAIRS_RANKS, out_dir)
    try:
        ref = pairs_run(None)
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    pranks = join_ranks(checks, "pairs", procs, out_dir)
    pairs_s = time.time() - t1
    worst_rows = 0.0
    for r in range(PAIRS_RANKS):
        got = torch.load(os.path.join(out_dir, f"pairs_rank{r}.pt"))
        n = got["rows"]
        checks.expect(n == PAIRS_LOCAL * PAIRS_RANKS * PAIRS_LOCAL,
                      f"pairs rank {r}: {n} rows == {PAIRS_LOCAL} texts x "
                      f"{PAIRS_RANKS * PAIRS_LOCAL} images")
        for o, w in zip(got["outputs"], ref["outputs"]):
            worst_rows = max(worst_rows, float((o - w[r * n:(r + 1) * n]).abs().max()))
        if r == 0:
            g_ratio = grad_ratio(got["grads"], ref["grads"], lambda w: 1e-4 * float(w.abs().max()))
    log(f"  (b) pair rows: worst |rank - one process| {worst_rows:.3e}; gradients, the five "
        "furthest (at 1e-4 of the tensor's max, plus phase 6's floor): " + ", ".join(
            f"{k} {g_ratio[k]:.3e}" for k in sorted(g_ratio, key=g_ratio.get)[-5:]))
    checks.expect(worst_rows <= 1e-4, f"pairs: each rank's rows within 1e-4 of its rows of one "
                                      f"process's (worst {worst_rows:.3e})")
    checks.expect(max(g_ratio.values()) <= 1.0,
                  f"pairs: the averaged gradients within 1e-4 of each max of one process's, plus "
                  f"1e-6 of the largest (worst {max(g_ratio.values()):.3e})")
    for name in ("attention", "attention_bwd", "layer_norm"):
        checks.expect(pranks[0]["launches"][name] > 0 and
                      pranks[0]["launches"][name] == pranks[1]["launches"][name],
                      f"pairs: {name} launched on both ranks ({pranks[0]['launches'][name]})")
    log(f"  (a) four ranks in {grid_s:.1f} s, (b) two ranks in {pairs_s:.1f} s (start-up, "
        f"models, gloo over the host and the one-process references included) [{card}]")
    checks.end_phase("in_batch_pairs across ranks")
    return {"launches": {"cc_train_model_axis_rank0": ranks[0]["bfloat16"]["launches"],
                         "pairs_two_ranks_rank0": pranks[0]["launches"]},
            "moment_bytes": [res["float32"]["moment_bytes"] for res in ranks],
            "replicated_bytes": replicated, "grid_s": grid_s, "pairs_s": pairs_s}


def tf_port_name(tf_name: str) -> str:
    """A google-research BERT variable's port parameter name, written out
    plainly (the reference ``load_tf_weights_in_bert``'s walk)."""
    import re

    name = re.sub(r"layer_(\d+)", r"layer.\1", tf_name.replace("/", "."))
    if name.endswith("output_bias"):
        return name[: -len("output_bias")] + "bias"
    for tf_leaf, leaf in (("kernel", "weight"), ("gamma", "weight"), ("beta", "bias")):
        if name.endswith("." + tf_leaf):
            return name[: -len(tf_leaf)] + leaf
    return name if name.endswith(".bias") else name + ".weight"


def phase_reader_and_tf_import(checks: Checks, tmp: str, card: str) -> dict:
    """(24) The native VFR reader: ``native/vfs/vfs.cc`` built into
    ``build/native_vfs`` (timed), a synthetic .vfr of 64 images x 101
    regions x 2048 features and 1601 targets read through it and through
    ``VrfFeatureStore``, every array equal, time per image of each. (25)
    The TF import: synthetic google-research BERT variables for every
    text-stream parameter of the full-width model through
    ``load_tf_weights``, each parameter against the plain mapping
    (``tf_port_name``; kernels transposed), the rest unchanged;
    ``load_tf_checkpoint`` on a checkpoint written here when tensorflow is
    installed, else reported skipped."""
    import numpy as np
    import torch

    from vilbert_tpu_torch.core.config import ModelConfig
    from vilbert_tpu_torch.core.tf_import import load_tf_checkpoint, load_tf_weights
    from vilbert_tpu_torch.data import native_vfs
    from vilbert_tpu_torch.data.feature_store import (
        InMemoryFeatureStore,
        VrfFeatureStore,
        VrfWriter,
    )
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    t0 = time.time()
    lib = native_vfs.build()
    build_s = time.time() - t0
    store = InMemoryFeatureStore.synthetic(num_images=64, num_boxes=101)
    path = os.path.join(tmp, "synthetic.vfr")
    with VrfWriter(path) as w:
        for k in store.keys():
            w.add(k, store.get(k))
    native, plain = native_vfs.NativeVrfFeatureStore(path), VrfFeatureStore(path)
    keys = store.keys()
    same = sorted(native.keys()) == sorted(plain.keys()) == sorted(keys)
    for k in keys:
        a, b = native.get(k), plain.get(k)
        same = same and all(np.array_equal(x, y) for x, y in (
            (a.features, b.features), (a.boxes, b.boxes), (a.target, b.target))) and (
            (a.image_h, a.image_w) == (b.image_h, b.image_w))
    times = {}
    for label, reader in (("native", native), ("python", plain)):
        t0 = time.perf_counter()
        for _ in range(5):
            for k in keys:
                rf = reader.get(k)
                float(rf.features[-1, -1])  # touch the record
        times[label] = (time.perf_counter() - t0) / (5 * len(keys)) * 1e6
    native.close()
    log(f"  native reader {os.path.relpath(lib)} built in {build_s:.1f} s; {len(keys)} images x 101 x 2048 (+1601 targets): "
        f"{times['native']:.1f} us an image native, {times['python']:.1f} us VrfFeatureStore")
    checks.expect(same and lib.parent.name == "native_vfs" and lib.parent.parent.name == "build",
                  "native reader built into build/native_vfs, every record equal to "
                  "VrfFeatureStore's")

    cfg = ModelConfig.from_json_file(CONFIG)
    model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(SEED))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED)
    variables = {}
    for name, shape in tf_text_stream_shapes(cfg).items():
        variables[name] = rng.standard_normal(shape, dtype=np.float32)
    variables["bert/pooler/dense/kernel"] = rng.standard_normal((768, 768), dtype=np.float32)
    variables["global_step"] = np.asarray(1000)
    t0 = time.time()
    report = load_tf_weights(model, variables)
    import_s = time.time() - t0
    after = model.state_dict()
    mapped = {tf_port_name(n): n for n in variables if not n.startswith(("bert/pooler",
                                                                          "global_step"))}
    ok = set(mapped) <= set(after) and len(report.loaded) == len(mapped)
    for port, tf in mapped.items():
        want = torch.from_numpy(variables[tf])
        want = want.T if port.endswith(".weight") and want.dim() == 2 and not (
            "embeddings" in port) else want
        ok = ok and torch.equal(after[port], want.to(after[port].dtype))
    unchanged = all(torch.equal(after[k], before[k]) for k in after if k not in mapped)
    log(f"  TF import: {len(report.loaded)} text-stream parameters of {len(after)} loaded in "
        f"{import_s:.1f} s, {len(report.unexpected)} without destination")
    checks.expect(ok and unchanged, "TF import at full width: every text-stream parameter "
                                    "equals the plain mapping of its variable, every other "
                                    "parameter unchanged")
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        try:
            load_tf_checkpoint(os.path.join(tmp, "none"))
        except ImportError as e:
            log(f"  load_tf_checkpoint skipped: tensorflow is not installed ({e})")
    else:
        log("  load_tf_checkpoint: tensorflow is installed; covered by "
            "tests/test_torch_tf_import.py, not run here")
    checks.end_phase("native reader and TF import")
    return {"native_us": times["native"], "python_us": times["python"], "build_s": build_s}


def tf_text_stream_shapes(cfg) -> dict:
    """google-research BERT variable name -> shape for the text stream of
    ``cfg`` (embeddings, encoder layers, LM head)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    out = {
        "bert/embeddings/word_embeddings": (cfg.vocab_size, h),
        "bert/embeddings/position_embeddings": (cfg.max_position_embeddings, h),
        "bert/embeddings/token_type_embeddings": (cfg.type_vocab_size, h),
        "bert/embeddings/LayerNorm/gamma": (h,), "bert/embeddings/LayerNorm/beta": (h,),
        "cls/predictions/transform/dense/kernel": (h, h),
        "cls/predictions/transform/dense/bias": (h,),
        "cls/predictions/transform/LayerNorm/gamma": (h,),
        "cls/predictions/transform/LayerNorm/beta": (h,),
        "cls/predictions/output_bias": (cfg.vocab_size,),
    }
    for n in range(cfg.num_hidden_layers):
        p = f"bert/encoder/layer_{n}/"
        for m in ("query", "key", "value"):
            out[f"{p}attention/self/{m}/kernel"] = (h, h)
            out[f"{p}attention/self/{m}/bias"] = (h,)
        out.update({f"{p}attention/output/dense/kernel": (h, h),
                    f"{p}attention/output/dense/bias": (h,),
                    f"{p}attention/output/LayerNorm/gamma": (h,),
                    f"{p}attention/output/LayerNorm/beta": (h,),
                    f"{p}intermediate/dense/kernel": (h, i), f"{p}intermediate/dense/bias": (i,),
                    f"{p}output/dense/kernel": (i, h), f"{p}output/dense/bias": (h,),
                    f"{p}output/LayerNorm/gamma": (h,), f"{p}output/LayerNorm/beta": (h,)})
    return out


def kernel_report(times: dict, err: dict, vqa_launches: dict, train_launches: dict,
                  mt_launches: dict, fp32_launches: dict, ret: dict, opts: dict,
                  base: dict, options: dict) -> list:
    """The kernels line. Each kernel's numbers (device ms, ``device_ms``;
    ``wall_ms`` with the host's gaps) at its headline shape: K1 at VQA image
    self-attention, where it costs most; K2 at CC image self-attention;
    both at rate 0, where SDPA computes the same function; K4 at the VQA
    image LayerNorm; K1 past 128 keys (the long tensor-core variant, with
    the CUDA-core one it replaces on bf16 as ``cc_ms``) and K2's wgmma
    variant at Visual7w image self-attention (with the mma.sync one it
    replaces as ``long_tc_ms``; that one's entry, launched by name only,
    carries its times with ``wg_ms`` beside them). Every main-path
    shape under ``shapes``; launches in the VQA eval run, the CC training
    run and the multi-task run under ``launches_by_path``, and ``launches``
    of the path the headline shape belongs to. The CUDA-core K1, which the
    bf16 paths no longer launch, reports its launches in phase 8's fp32
    iteration through the kernels and its times at the long shapes. K1 and
    K4 also carry their launches in phase 10's retrieval runs and demo; K4's
    bf16-weight instantiation is an entry of its own, with its launches in
    phase 11's CC steps with bf16 gradients and its times at the CC and
    multi-task shapes. The baseline's and NCE's paths (phases 13-17) add
    their launches under ``launches_by_path``, and phase 18's shapes join
    ``shapes`` (the long ones, past 128 keys, those of the long variants).
    The model options' paths (``options``: phases 19-21's int8 eval and
    demo, visualization forward and remat CC steps) add theirs; K1 with its
    probabilities output is an entry of its own, at VQA image
    self-attention in phase 20's batch, with its launches in phase 20's
    forward (K1's entry carries them as ``launches_probs`` too)."""
    from vilbert_tpu_torch.ops.attention import TC_MAX_SEQ
    from vilbert_tpu_torch.ops.layernorm import VARIANTS as LN_VARIANTS

    long_labels = tuple(label for label, *_ in MT_ATTENTIONS + LONG_TIMED) + tuple(
        label for label, _, _, _, sk, *_ in baseline_attentions() if sk > TC_MAX_SEQ)

    def entry(name, source, replaces, counter, key, library, variant=None):
        row = times[key]
        long = key[1] in long_labels
        shapes = [dict(shape=" ".join(map(str, k[1:])), **v) for k, v in times.items()
                  if k[0] == key[0] and (k[1] in long_labels) == long
                  and variant in (None, v.get("variant"))]
        path = mt_launches if long else vqa_launches if (
            key[1].startswith("VQA") or key[0] == "layer_norm") else train_launches
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": path[counter],
               "launches_by_path": {"vqa_eval": vqa_launches[counter],
                                    "cc_train": train_launches[counter],
                                    "multitask_train": mt_launches[counter]},
               "max_abs_err": err[name],
               "ms": row["ms"], "plain_ms": row["plain_ms"], "wall_ms": row["wall_ms"],
               "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"], "bound": "memory",
               "library_ms": row["library_ms"], "library": library,
               "shape": " ".join(map(str, key[1:])), "shapes": shapes}
        out.update({f"{v}_ms": row[f"{v}_ms"] for v in OTHER_VARIANTS if f"{v}_ms" in row})
        return out

    sdpa = "torch.nn.functional.scaled_dot_product_attention, rate 0"
    head = ("attention_fwd", "VQA image self", 0.0)
    fwd = entry("attention_fwd", "vilbert_tpu_torch/csrc/" + (
        "attention_fwd_wg.cu" if times[head]["variant"] == "wg" else "attention.cu"),
        "vilbert_tpu/ops/pallas_attention_train.py:69", "attention", head, sdpa)
    fwd["variant"] = times[head]["variant"]
    # every path's K1 launches by variant
    paths = {"vqa_eval": vqa_launches, "cc_train": train_launches, "multitask_train": mt_launches,
             "retrieval_fast": ret["fast"], "retrieval_zero_shot": ret["zero_shot"],
             "demo": ret["demo"], "baseline_vqa_eval": base["vqa"],
             "baseline_cc_train": base["cc"], "baseline_multitask_train": base["multitask"],
             "baseline_retrieval": {k: sum(lt[k] for lt in base["retrieval"].values())
                                    for k in ("attention_tc", "attention_long_tc", "attention_wg",
                                              "attention_cc")},
             "nce_cc_train": base["nce"]["launches"], **options}
    for v in ("tc", "long_tc", "wg", "cc"):
        fwd[f"launches_{v}"] = {path: launches[f"attention_{v}"]
                                for path, launches in paths.items()}

    def variant_entry(name, source, variant, key, launches, launches_of):
        """A K1 variant's own entry: its time at every K1 row where it ran,
        routed there or named beside the routed variant."""
        def own(row):
            return row["ms"] if row.get("variant") == variant else row.get(f"{variant}_ms")

        rows = {k: v for k, v in times.items() if k[0] == "attention_fwd" and own(v) is not None}
        row = rows[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "vilbert_tpu/ops/pallas_attention_train.py:69",
                "launches": launches, "launches_of": launches_of,
                "launches_by_path": fwd[f"launches_{variant}"],
                "max_abs_err": err[f"attention_fwd_{variant}"], "ms": own(row),
                **{k: row[k] for k in ("plain_ms", "bound_ms", "bound_by", "library_ms")},
                "bound": "memory", "library": sdpa, "shape": " ".join(map(str, key[1:])),
                "shapes": [dict(v, shape=" ".join(map(str, k[1:])), ms=own(v),
                                routed=v.get("variant")) for k, v in rows.items()]}

    fwd_wg = variant_entry("attention_fwd_wg", "vilbert_tpu_torch/csrc/attention_fwd_wg.cu",
                           "wg", head, vqa_launches["attention_wg"], "the VQA eval run (phase 4)")
    fwd_wg["variant"] = ("wg: wgmma, bf16, Sk <= 1024; routed by fwd_variant, else named beside "
                         "the routed variant")
    bwd = entry("attention_bwd", "vilbert_tpu_torch/csrc/attention_bwd.cu",
                "vilbert_tpu/ops/pallas_attention_train.py:81", "attention_bwd",
                ("attention_bwd", "CC image self", 0.0),
                "scaled_dot_product_attention forward + autograd.grad less forward, rate 0")
    bwd["launches_tc"] = train_launches["attention_bwd_tc"]
    ln = entry("layer_norm_fwd", "vilbert_tpu_torch/csrc/layernorm.cu",
               "vilbert_tpu/ops/pallas_layernorm.py:28", "layer_norm", ("layer_norm", "VQA image"),
               "torch.nn.functional.layer_norm(x + residual), the add inside the timed call")
    ln["variants"] = {v: {"launches_by_path": {
        "vqa_eval": vqa_launches[f"layer_norm_{v}"], "cc_train": train_launches[f"layer_norm_{v}"],
        "multitask_train": mt_launches[f"layer_norm_{v}"]}} for v in LN_VARIANTS}
    # the K3 entry has no kernel of its own: K1 + K2 at rate 0
    f0 = times[("attention_fwd", "CC image self", 0.0)]
    b0 = times[("attention_bwd", "CC image self", 0.0)]
    fused = {"name": "fused_attention", "route": "cuda",
             "source": "vilbert_tpu_torch/ops/attention.py",
             "replaces": "vilbert_tpu/ops/pallas_attention.py:33",
             "served_by": "attention_fwd + attention_bwd at rate 0", "launches": 0,
             "max_abs_err": err["fused_attention"],
             "ms": f0["ms"] + b0["ms"], "plain_ms": f0["plain_ms"] + b0["plain_ms"],
             "wall_ms": f0["wall_ms"] + b0["wall_ms"],
             "bound_ms": f0["bound_ms"] + b0["bound_ms"], "bound_by": "bytes", "bound": "memory",
             "library_ms": f0["library_ms"] + b0["library_ms"],
             "library": "scaled_dot_product_attention forward + autograd.grad",
             "shape": "CC image self 0.0"}
    fwd_long = variant_entry("attention_fwd_long_tc", "vilbert_tpu_torch/csrc/attention.cu",
                             "long_tc", ("attention_fwd", "Visual7w image self", 0.0),
                             mt_launches["attention_long_tc"], "the multi-task run (phase 8)")
    fwd_long["variant"] = ("long_tc: mma.sync, bf16, Sk <= 1024; routed by fwd_variant, else "
                           "named beside the routed variant")
    # the CUDA-core K1: fp32 on the paths; its bf16 times beside the long
    # tensor-core variant
    cc_keys = ("plain_ms", "bound_ms", "bound_by", "library_ms")
    fwd_cc = {"name": "attention_fwd_cc", "route": "cuda", "source": fwd_long["source"],
              "replaces": fwd_long["replaces"], "launches": fp32_launches["attention_cc"],
              "launches_of": "phase 8's fp32 iteration through the kernels",
              "launches_by_path": {"vqa_eval": vqa_launches["attention_cc"],
                                   "cc_train": train_launches["attention_cc"],
                                   "multitask_train": mt_launches["attention_cc"],
                                   "multitask_fp32_check": fp32_launches["attention_cc"]},
              "max_abs_err": err["attention_fwd_cc"],
              "ms": times[("attention_fwd", "Visual7w image self", 0.0)]["cc_ms"],
              **{k: fwd_long[k] for k in (*cc_keys, "bound", "library", "shape")},
              "long_tc_ms": fwd_long["ms"],
              "shapes": [{"shape": s["shape"], "ms": s["cc_ms"], "long_tc_ms": s["ms"],
                          **{k: s[k] for k in cc_keys}} for s in fwd_long["shapes"]
                         if "cc_ms" in s],
              "variant": "cc: CUDA cores, fp32 (bf16 when named), bf16 times here"}
    bwd_wg = entry("attention_bwd_wg", "vilbert_tpu_torch/csrc/attention_bwd_wg.cu",
                   "vilbert_tpu/ops/pallas_attention_train.py:81", "attention_bwd_wg",
                   ("attention_bwd", "Visual7w image self", 0.0),
                   "scaled_dot_product_attention forward + autograd.grad less forward, rate 0",
                   variant="wg")
    bwd_wg["variant"] = ("wg: wgmma, bf16, Sq or Sk past 128, from the forward's output and row "
                         "log-sum-exps")
    # the mma.sync K2 past 128 that "wg" took over: timed by name beside it
    # at its shapes, checked by name in phases 3 and 12; launched on no path
    lt_keys = ("plain_ms", "bound_ms", "bound_by", "library_ms")
    bwd_long = {"name": "attention_bwd_long_tc", "route": "cuda",
                "source": "vilbert_tpu_torch/csrc/attention_bwd.cu", "replaces": bwd_wg["replaces"],
                "launches": mt_launches["attention_bwd_long_tc"],
                "launches_of": "the multi-task iteration (phase 8): none, wg took its shapes; "
                               "launched by name in phases 3, 9, 12 and 18",
                "launches_by_path": {"vqa_eval": vqa_launches["attention_bwd_long_tc"],
                                     "cc_train": train_launches["attention_bwd_long_tc"],
                                     "multitask_train": mt_launches["attention_bwd_long_tc"]},
                "max_abs_err": err["attention_bwd_long_tc"], "ms": bwd_wg["long_tc_ms"],
                **{k: bwd_wg[k] for k in (*lt_keys, "bound", "library", "shape")},
                "wg_ms": bwd_wg["ms"],
                "shapes": [{"shape": sh["shape"], "ms": sh["long_tc_ms"], "wg_ms": sh["ms"],
                            **{k: sh[k] for k in lt_keys}} for sh in bwd_wg["shapes"]
                           if "long_tc_ms" in sh],
                "variant": "long_tc: mma.sync, bf16, Sq or Sk past 128 (named only)"}
    for out, counter in ((fwd, "attention"), (ln, "layer_norm")):
        out["launches_by_path"].update({f"retrieval_{k}" if k != "demo" else k: ret[k][counter]
                                        for k in ("fast", "zero_shot", "demo")})
    for out, counter in ((fwd, "attention"), (bwd, "attention_bwd"), (ln, "layer_norm"),
                         (bwd_long, "attention_bwd_long_tc"), (bwd_wg, "attention_bwd_wg")):
        out["launches_by_path"].update({
            "baseline_vqa_eval": base["vqa"][counter], "baseline_cc_train": base["cc"][counter],
            "baseline_multitask_train": base["multitask"][counter],
            "baseline_retrieval": sum(lt[counter] for lt in base["retrieval"].values()),
            "nce_cc_train": base["nce"]["launches"][counter]})
    for out, counter in ((fwd, "attention"), (bwd, "attention_bwd"), (ln, "layer_norm"),
                         (bwd_long, "attention_bwd_long_tc"), (bwd_wg, "attention_bwd_wg")):
        out["launches_by_path"].update({k: v[counter] for k, v in options.items()})
    fwd["launches_probs"] = options["vqa_visualization"]["attention_probs"]
    probs_rows = {k: v for k, v in times.items() if k[0] == "attention_fwd_probs"}
    head = next(k for k in probs_rows if k[1].startswith("VQA image self"))
    row = probs_rows[head]
    fwd_probs = {
        "name": "attention_fwd_probs", "route": "cuda", "source": fwd["source"],
        "replaces": fwd["replaces"],
        "launches": options["vqa_visualization"]["attention_probs"],
        "launches_of": "phase 20's visualization forward",
        "launches_by_variant": {v: options["vqa_visualization"][f"attention_{v}"]
                                for v in ("tc", "long_tc", "cc", "wg")},
        "max_abs_err": err["attention_fwd_probs"],
        **{k: row[k] for k in ("ms", "plain_ms", "wall_ms", "bound_ms", "bound_by",
                               "library_ms")},
        "bound": "memory", "library": None,
        "library_note": "no single PyTorch call returns the attention probabilities",
        "shape": head[1], "shapes": [dict(shape=k[1], **v) for k, v in probs_rows.items()],
        "variant": "K1's routed variant with its probabilities output (P after dropout, "
                   "[B, h, Sq, Sk]); long_tc and wg past 128 keys in a second sweep over the "
                   "key tiles"}
    bf16w = {k: v for k, v in times.items() if k[0] == "layer_norm_bf16_weight"}
    head = max(bf16w, key=lambda k: bf16w[k]["launches_by_path"]["cc"])  # CC text + residual
    row = bf16w[head]
    ln_bf16w = {
        "name": "layer_norm_fwd_bf16_weight", "route": "cuda", "source": ln["source"],
        "replaces": ln["replaces"],
        "launches": opts["bf16_launches"]["layer_norm_bf16_weight"],
        "launches_of": "phase 11's CC steps with --bf16_grads",
        "variants": {v: opts["bf16_launches"][f"layer_norm_{v}"] for v in LN_VARIANTS},
        "max_abs_err": err["layer_norm_fwd_bf16_weight"],
        **{k: row[k] for k in ("ms", "plain_ms", "wall_ms", "bound_ms", "bound_by",
                               "library_ms")},
        "bound": "memory", "library": ln["library"], "shape": head[1],
        "shapes": [dict(shape=k[1], **v) for k, v in bf16w.items()],
        "weight": "bf16 weight and bias, widened in registers"}
    return [fwd, bwd, ln, fused, fwd_long, fwd_cc, bwd_long, ln_bf16w, fwd_probs, bwd_wg, fwd_wg]


def main() -> int:
    import torch

    t_start = time.time()
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
    t_phase = time.time()

    def phase(title: str) -> None:
        nonlocal t_phase
        log(f"  ({time.time() - t_phase:.1f} s)")
        t_phase = time.time()
        log(title)

    phase("[3 kernels vs plain]")
    err = phase_kernels(checks)
    phase("[4 slice]")
    model, cfg, vqa_launches = phase_slice(checks)
    phase("[5 timing]")
    times = phase_timing(checks, model, cfg, card, err)
    del model
    phase("[6 train slice]")
    state, args, train_launches = phase_train(checks)
    phase("[7 train timing]")
    times.update(phase_train_timing(checks, state, args, card, err))
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase("[8 multi-task slice]")
        trainer, mt_launches, fp32_launches, peak_gb, mt_losses = phase_multitask(checks, tmp)
        phase("[9 multi-task timing]")
        times.update(phase_multitask_timing(checks, trainer, card, err))
        mt_iteration_s = [times[("multitask_iteration", i)]["s"] for i in range(2)]
        torch.cuda.empty_cache()
        phase("[10 retrieval and demo]")
        ret_times, ret = phase_retrieval(checks, tmp, card, err)
        times.update(ret_times)
        torch.cuda.empty_cache()
        phase("[11 training options and resume]")
        opt_times, opts = phase_training_options(checks, trainer, tmp, card, err)
        times.update(opt_times)
        del trainer
        torch.cuda.empty_cache()
        phase("[12 K1 and K2 past 512 keys]")
        times.update(phase_long_kernels(checks, err, card))
        base = {}
        phase("[13 baseline VQA eval]")
        base["vqa"], base["vqa_questions_per_s"] = phase_baseline_vqa(checks, card)
        torch.cuda.empty_cache()
        phase("[14 baseline CC step]")
        base["cc"], base["cc_samples_per_s"] = phase_baseline_train(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[15 NCE CC step]")
        base["nce"] = phase_nce(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[16 baseline multi-task]")
        base["multitask"], _ = phase_baseline_multitask(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[17 baseline retrieval]")
        base["retrieval"], base_ret = phase_baseline_retrieval(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[18 baseline timing]")
        times.update(phase_baseline_timing(checks, card, err))
        torch.cuda.empty_cache()
        phase("[19 int8 inference]")
        int8 = phase_int8(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[20 visualization]")
        vis_times, vis = phase_visualization(checks, card, err)
        times.update(vis_times)
        torch.cuda.empty_cache()
        phase("[21 remat]")
        remat = phase_remat(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[22 prefetch]")
        held = times[("train", "kernels")]
        pre = phase_prefetch(checks, tmp, card, sum(held) / len(held), mt_losses,
                             mt_iteration_s)
        phase("[23a data parallel: NCCL, one rank]")
        nccl = phase_nccl_one_rank(checks, tmp, card, mt_losses)
        phase("[23b data parallel: two ranks over gloo]")
        two = phase_two_ranks(checks, tmp, card)
        torch.cuda.empty_cache()
        phase("[24-25 native reader, TF import]")
        reader = phase_reader_and_tf_import(checks, tmp, card)
        phase("[26 model axis and in_batch_pairs across ranks]")
        axis = phase_model_axis(checks, tmp, card)
    log(f"  int8 VQA questions/s at B={TIME_BATCH}: "
        f"{ {k: round(v, 1) for k, v in int8['questions_per_s'].items()} }, quantization "
        f"passes' share { {k: round(v, 4) for k, v in int8['quantize_share'].items()} }; "
        f"visualization forward B={VIS_BATCH} ms {vis['forward_ms']}; remat CC step "
        f"{ {k: v for k, v in remat.items() if k != 'launches'} } [{card}]")
    log(f"  prefetch: CC driver { {d: round(r['samples_per_s'], 1) for d, r in pre['cc'].items()} }"
        f" samples/s, idle { {d: round(r['idle_share'], 3) for d, r in pre['cc'].items()} }; "
        f"flagship iteration { {d: round(r['samples_per_s'], 1) for d, r in pre['multitask'].items()} }"
        f" samples/s, idle { {d: round(r['idle_share'], 3) for d, r in pre['multitask'].items()} }"
        f" (depth: value); native reader {reader['native_us']:.1f} us an image, "
        f"VrfFeatureStore {reader['python_us']:.1f} [{card}]")
    phase(f"[done] phases 1-26 in {time.time() - t_start:.1f} s; multi-task peak memory "
          f"{peak_gb:.2f} GB; retrieval captions/s {ret['captions_per_s']}; flagship "
          f"checkpoint {opts['checkpoint_gb']:.3f} GB saved in {opts['save_s']:.2f} s, restored "
          f"in {opts['restore_s']:.2f} s; baseline: {base['vqa_questions_per_s']:.1f} VQA "
          f"questions/s, {base['cc_samples_per_s']:.1f} CC samples/s, retrieval captions/s "
          f"{ {k: round(v['captions_per_s'], 3) for k, v in base_ret.items()} }; NCE CC "
          f"{base['nce']['samples_per_s']:.1f} samples/s, peak {base['nce']['peak_gb']:.2f} GB "
          f"[{card}]")

    kernels = kernel_report(times, err, vqa_launches, train_launches, mt_launches, fp32_launches,
                            ret, opts, base, {"vqa_int8_eval": int8["launches"],
                                              "demo_int8": int8["demo_launches"],
                                              "vqa_visualization": vis["launches"],
                                              "cc_train_remat": remat["launches"],
                                              **pre["launches"], **nccl["launches"],
                                              **two["launches"], **axis["launches"]})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp_worker"]:  # a rank of phase 23b, started by it
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--rank_worker"]:  # a rank of phase 26, started by it
        sys.exit(rank_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
