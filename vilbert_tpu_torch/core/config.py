"""Typed configuration system.

The port's own copy of ``vilbert_tpu/core/config.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

One typed config covers the reference's three config tiers (SURVEY.md §5):
argparse CLI flags, model-architecture JSON (reference ``BertConfig``,
vilbert/vilbert.py:141-294), and the per-task YAML (``vilbert_tasks.yml``).

``ModelConfig`` accepts the reference's JSON config files verbatim
(e.g. ``config/bert_base_6layer_6conect.json``) so published checkpoints and
recipes carry over; unknown keys (like the vestigial ``pooling_method``) are
ignored exactly as the reference's ``BertConfig.from_dict`` effectively does.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


@dataclass(frozen=True)
class ModelConfig:
    """Architecture + behavior flags of the two-stream ViLBERT model.

    Field semantics follow the reference ``BertConfig``
    (vilbert/vilbert.py:141-294); defaults match the reference defaults.
    """

    # --- text stream ---
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    # --- vision stream ---
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 768
    v_num_hidden_layers: int = 3
    v_num_attention_heads: int = 12
    v_intermediate_size: int = 3072
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.02
    num_locs: int = 5  # [x1, y1, x2, y2, area], normalized

    # --- cross stream (co-attention) ---
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 16
    bi_intermediate_size: int = 1024
    bi_attention_type: int = 1
    v_biattention_id: Tuple[int, ...] = (0, 1)
    t_biattention_id: Tuple[int, ...] = (10, 11)
    with_coattention: bool = True

    # --- behavior flags ---
    visual_target: int = 0  # 0=KL vs soft dist, 1=MSE regression, 2=NCE
    fast_mode: bool = False
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    in_batch_pairs: bool = False
    fusion_method: str = "mul"  # "sum" | "mul"
    dynamic_attention: bool = False
    objective: int = 0
    num_negative: int = 128
    model: str = "bert"  # "bert" | "roberta"
    task_specific_tokens: bool = False
    num_task_tokens: int = 20
    visualization: bool = False

    # --- TPU-specific knobs (not in the reference) ---
    compute_dtype: str = "bfloat16"  # matmul/activation dtype
    param_dtype: str = "float32"
    use_pallas_attention: bool = False
    use_pallas_layernorm: bool = False
    use_fast_dropout: bool = True  # counter-hash dropout (ops/dropout.py)
    # dtype of the attention scores/softmax. "auto" follows compute_dtype
    # (flax's own dot_product_attention convention); set "float32" to pin
    # fp32 stats regardless of bf16 compute. bf16 scores halve the
    # [B,h,Sq,Sk] HBM traffic and drop the backward converts (measured
    # 1921 -> 2026 samples/s/chip); the reference's own fp16 mode ran
    # softmax in fp16 (model.half(), train_concap.py:504-505), so this is
    # no looser than the published recipe. Parity tests run fp32 compute,
    # where "auto" resolves to fp32.
    softmax_dtype: str = "auto"
    # gelu erf implementation. "auto" uses a P3/Q3 rational minimax erf
    # under bf16 compute (max abs err 9.7e-6 on erf; at bf16 precision
    # MORE accurate than the exact-erf lowering, whose internal bf16
    # roundings cost several ulps — within 1 ulp or 5e-5 of the
    # correctly-rounded true gelu everywhere; pinned by
    # tests/test_encoder_modes.py) and the exact erf under fp32 (parity
    # tests unaffected). XLA expands exact erf into a ~30-op branchy f32
    # erfc polynomial fused into the FFN GEMM epilogue; the roofline table
    # (docs/perf.md) attributed the forward FFN's 42%-of-bound gap to it.
    # "exact"/"rational" force one implementation.
    gelu_impl: str = "auto"
    # counter-hash dropout mixer (ops/dropout.py). "murmur3": 3 u32
    # multiplies/element (full murmur3 finalizer). "mix2": 2 multiplies —
    # u32 multiply is emulated on the VPU, and dropout hashes ~600M
    # elements/step, so the saved round is measurable; keep-rate and
    # lag-autocorrelation quality pinned in
    # tests/test_fast_dropout.py::test_hash_variant_statistics.
    dropout_hash: str = "murmur3"
    # one [D,3H] projection GEMM per attention. Measured SLOWER than three
    # separate Dense ops on v5e (1774 vs 1923 samples/s/chip): the per-step
    # concatenate of the three kernels (kept separate for checkpoint parity)
    # costs more than the wide-GEMM gain at these shapes. Default off;
    # kept for A/B (bench.py --no_fused_qkv toggles, docs/perf.md).
    fused_qkv: bool = False
    # project q/k/v straight into head-major [B, h, S, d] (the layout the
    # attention dots want) and fold the head merge into the output
    # projection. Removes the [B,S,H]<->[B,h,S,d] layout copies XLA
    # otherwise inserts around every attention dot (~12 ms/step in the
    # round-2 profile). Params stay Dense-compatible (checkpoint parity).
    head_major_attention: bool = True
    # how the head-major Head/Merge projections are spelled (A/B knob; the
    # einsum backward makes XLA materialize TWO relayouts of each attention
    # cotangent — ~6.8 GB/step of layout copies in the round-3 HLO
    # histogram):
    # - "einsum": folded einsum fwd+bwd (autodiff),
    # - "gemm": 2D GEMM + explicit transpose fwd (measured 6% slower — the
    #   forward pays a materialized transpose the einsum's dot avoids),
    # - "custom_bwd": einsum forward (bit-identical to "einsum") with a
    #   custom VJP sharing ONE cotangent relayout between dX/dW (ops/proj.py)
    proj_impl: str = "einsum"
    remat: bool = False  # jax.checkpoint each encoder block
    # INFERENCE-ONLY: dynamic int8 matmuls (ops/quant.py) — per-tensor
    # activation / per-channel weight symmetric quantization in-graph; the
    # v5e MXU runs int8 at 2x the bf16 rate. Checkpoints are unchanged
    # (weights stay fp32/bf16; quantize happens in the forward). No custom
    # gradient rules: training with this flag is undefined behavior.
    int8_matmul: bool = False
    # INFERENCE-ONLY: static-calibrated int8 (ops/quant.py module docstring).
    # Per-channel activation scales are recorded by a calibration pass
    # (apply with mutable=["quant"]) and folded into the weight quantization
    # — no per-call activation abs-max reduction. Inference applies must be
    # given the calibrated "quant" collection.
    int8_static: bool = False

    @property
    def int8_enabled(self) -> bool:
        return self.int8_matmul or self.int8_static

    def __post_init__(self):
        if self.visual_target != 0 and self.v_target_size != self.v_feature_size:
            # feature-space region targets (MSE regression / NCE): the image
            # head must predict v_feature_size dims, not the 1601-class
            # detector distribution (reference train_concap.py:355-360 sets
            # v_target_size 2048 for visual_target 1/2)
            object.__setattr__(self, "v_target_size", self.v_feature_size)
        assert len(self.v_biattention_id) == len(self.t_biattention_id)
        if self.v_biattention_id:
            assert max(self.v_biattention_id) < self.v_num_hidden_layers
            assert max(self.t_biattention_id) < self.num_hidden_layers
        assert self.hidden_size % self.num_attention_heads == 0
        assert self.v_hidden_size % self.v_num_attention_heads == 0
        assert self.bi_hidden_size % self.bi_num_attention_heads == 0
        assert self.fusion_method in ("sum", "mul")
        # fail at construction, not as an opaque jnp.dtype error at trace time
        assert self.proj_impl in ("einsum", "gemm", "custom_bwd"), (
            f"proj_impl must be 'einsum', 'gemm' or 'custom_bwd', "
            f"got {self.proj_impl!r}"
        )
        assert self.softmax_dtype in ("auto", "float32", "bfloat16"), (
            f"softmax_dtype must be 'auto', 'float32' or 'bfloat16', "
            f"got {self.softmax_dtype!r}"
        )
        assert self.gelu_impl in ("auto", "exact", "rational"), (
            f"gelu_impl must be 'auto', 'exact' or 'rational', "
            f"got {self.gelu_impl!r}"
        )
        assert self.dropout_hash in ("murmur3", "mix2"), (
            f"dropout_hash must be 'murmur3' or 'mix2', "
            f"got {self.dropout_hash!r}"
        )

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides: Any) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        kwargs.update(overrides)
        for key in ("v_biattention_id", "t_biattention_id"):
            if key in kwargs and not isinstance(kwargs[key], tuple):
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)

    @classmethod
    def from_json_file(cls, path: str, **overrides: Any) -> "ModelConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f), **overrides)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["v_biattention_id"] = list(self.v_biattention_id)
        d["t_biattention_id"] = list(self.t_biattention_id)
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def replace(self, **overrides: Any) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # -- derived ------------------------------------------------------------

    @property
    def resolved_gelu_impl(self) -> str:
        if self.gelu_impl == "auto":
            return (
                "rational" if self.compute_dtype == "bfloat16" else "exact"
            )
        return self.gelu_impl

    @property
    def resolved_softmax_dtype(self) -> str:
        return (
            self.compute_dtype if self.softmax_dtype == "auto"
            else self.softmax_dtype
        )

    @property
    def num_connection_layers(self) -> int:
        return len(self.v_biattention_id)

    def encoder_schedule(self) -> List[Tuple[str, int]]:
        """The static interleave schedule of the two-stream encoder.

        Returns an ordered list of ("t"|"v"|"c", layer_index) ops replicating
        the reference scheduler (vilbert/vilbert.py:934-1096): for each
        connection i, text layers up to ``t_biattention_id[i]``, then image
        layers up to ``v_biattention_id[i]``, then connection layer i; finally
        the trailing image and text layers.
        """
        ops: List[Tuple[str, int]] = []
        v_start = t_start = 0
        for count, (v_end, t_end) in enumerate(
            zip(self.v_biattention_id, self.t_biattention_id)
        ):
            for idx in range(t_start, t_end):
                ops.append(("t", idx))
            for idx in range(v_start, v_end):
                ops.append(("v", idx))
            if self.with_coattention:
                ops.append(("c", count))
            v_start, t_start = v_end, t_end
        for idx in range(v_start, self.v_num_hidden_layers):
            ops.append(("v", idx))
        for idx in range(t_start, self.num_hidden_layers):
            ops.append(("t", idx))
        return ops


# ---------------------------------------------------------------------------
# Per-task configuration (reference vilbert_tasks.yml)
# ---------------------------------------------------------------------------

#: Task head types (reference vilbert_tasks.yml `type:` field / task_utils.py)
TASK_TYPES = (
    "VL-classifier",        # VQA-style soft-label classification (3129)
    "VL-classifier-GQA",    # GQA 1533-way
    "VL-logit",             # option ranking via vil_logit (VCR, retrieval, dialog)
    "V-logit",              # per-region grounding logit (refcoco family, flickr)
    "V-logit-mc",           # multiple-choice pointing (Visual7w, GuessWhatPointing)
    "VL-binary-classifier", # NLVR2 / FOIL two-way
    "VL-tri-classifier",    # SNLI-VE / GuessWhat three-way
)

#: Batch reshape modes applied by the trainer (reference task_utils.py:199-310)
PROCESS_MODES = ("normal", "dialog", "expand", "retrieval", "nlvr")


@dataclass(frozen=True)
class TaskConfig:
    """One task entry of the multi-task YAML (reference vilbert_tasks.yml)."""

    task_id: int
    name: str
    type: str
    loss: str                      # "BCEWithLogitLoss" | "CrossEntropyLoss"
    process: str = "normal"
    dataroot: str = ""
    features_path: str = ""        # reference features_h5path1 (detector feats)
    features_path_gt: str = ""     # reference features_h5path2 (GT-box feats)
    train_annotations_jsonpath: str = ""
    val_annotations_jsonpath: str = ""
    max_seq_length: int = 23
    max_region_num: int = 101
    batch_size: int = 128
    eval_batch_size: int = 256
    train_split: str = "train"
    val_split: str = "val"
    lr: float = 4e-5
    num_epoch: int = 20
    num_labels: int = 0            # head width where applicable

    def __post_init__(self):
        assert self.type in TASK_TYPES, self.type
        assert self.process in PROCESS_MODES, self.process


def load_task_configs(path: str) -> Dict[str, TaskConfig]:
    """Parse a tasks YAML (same schema as the reference vilbert_tasks.yml)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        raw = yaml.safe_load(f)
    out: Dict[str, TaskConfig] = {}
    for key, cfg in raw.items():
        known = {f.name for f in dataclasses.fields(TaskConfig)}
        kwargs = {}
        for k, v in cfg.items():
            # accept both our names and the reference's h5path names
            if k == "features_h5path1":
                kwargs["features_path"] = v
            elif k == "features_h5path2":
                kwargs["features_path_gt"] = v
            elif k in known:
                kwargs[k] = v
        out[key] = TaskConfig(**kwargs)
    return out


# ---------------------------------------------------------------------------
# Training-run configuration (replaces reference argparse soup)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # "adamw" | "radam"
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    # Adam bias correction. The reference multi-task trainer runs
    # AdamW(correct_bias=False) (train_tasks.py:425) — MultiTaskTrainer's
    # default opt config mirrors that; CC pretraining keeps the default True
    # (train_concap.py:466 leaves pytorch_transformers' default).
    correct_bias: bool = True
    # storage dtypes of the Adam moments (m, v). "bfloat16" halves the
    # moment's HBM footprint and the optimizer-walk traffic — the fp32-state
    # adamw walk is HBM-bound (~7 GB/step at bert_base scale; at bert_large
    # it is ~18% of the step, docs/perf.md). Moment updates always
    # ACCUMULATE in fp32 (only storage is compressed). v tolerates bf16
    # well (sqrt compresses its dynamic range); m in bf16 adds relative
    # error ~2e-3 per step to the update direction — measured neutral on
    # the CC bench losses, kept default-off for recipe parity.
    first_moment_dtype: str = "float32"
    second_moment_dtype: str = "float32"
    warmup_proportion: float = 0.1
    # per-iteration: "warmup_linear" | "warmup_constant" | "constant";
    # epoch-composed (reference train_tasks.py:440-457, require external_lr):
    # "mannul" | "automatic" | "cosine" | "cosine_warm"
    schedule: str = "warmup_linear"
    head_lr: Optional[float] = None  # lr override for task heads ("vil_" params)
    pretrained_lr_scale: float = 1.0  # lr multiplier for pretrained BERT params
    # reference --vision_scratch (train_tasks.py:400-411): when fine-tuning
    # from a TEXT-ONLY BERT init, everything outside the text stream (vision
    # stream, co-attention, poolers) is fresh and trains at head_lr; only
    # the text embeddings + text encoder layers keep base lr
    vision_scratch: bool = False
    grad_clip_norm: Optional[float] = None


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    num_train_steps: int = 1000
    gradient_accumulation_steps: int = 1
    log_every: int = 20
    eval_every: int = 0            # 0 = per-epoch semantics handled by driver
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 0
    mesh_shape: Tuple[int, ...] = (-1,)   # -1 = all devices on the data axis
    mesh_axes: Tuple[str, ...] = ("data",)
    # freeze params whose path starts with this prefix (or any of a tuple of
    # prefixes — the CLI's integer --freeze N expands to one prefix per
    # frozen text layer, cli.train_tasks.freeze_prefixes)
    freeze_prefix: Union[str, Tuple[str, ...]] = ""
    train_iter_gap: int = 4        # gating for stopped tasks (train_tasks.py:516-521)
    # scales per-task iterations/epoch (reference --train_iter_multiplier,
    # train_tasks.py:333-341: ave_iter = num_epoch*len(loader)*mult/epochs)
    train_iter_multiplier: float = 1.0
    prefetch_batches: int = 2      # per-task device prefetch depth (0 = off)
    # storage dtype of gradients ("" = loss dtype). "bfloat16" halves the
    # gradient HBM footprint; the loss is differentiated w.r.t. a bf16 cast
    # of the params so cotangents materialize in bf16 (parallel/train_step.py)
    grad_dtype: str = ""
