"""The two-stream ViLBERT model, its pretraining model and task heads, in PyTorch.

Counterpart of ``vilbert_tpu/models/vilbert.py`` (reference
vilbert/vilbert.py). Parity quirks kept: the task token is spliced in after
the position embeddings; masks are -10000 additive biases; the image-pad
mask of ``vision_logit``; the tied LM decoder (the LM head reads the word
embedding table, so there is no ``cls.predictions.decoder`` parameter); the
co-attention mask is accepted and inert; heads are computed selectively
(``heads=``), ``None`` computes all of them.

``int8_matmul`` and ``int8_static`` run every dense site in int8
(``models.layers.Linear``, ``ops.quant``; inference only).
``visualization`` returns the attention maps of the forward on the output
(``attention_probs``: {name: [B, h, Sq, Sk]}, one per attention site and two
per co-attention layer, named by module path so that
``core.weights.flax_path`` gives the flax ``intermediates`` path the JAX
model sows each under). ``remat`` recomputes each text, image and
connection layer in the backward (``torch.utils.checkpoint``), drawing the
dropout seeds the forward drew. ``in_batch_pairs`` expands a batch of B
texts and B images to the B^2 (text i, image j) pairs once, just before
the first connection layer, and composes with ``fast_mode`` as in the JAX
package (the expansion first, then the broadcast). Over the data axis of a
mesh (``set_pair_mesh``), where the JAX package pairs the global batch,
each rank gathers the image stream of every data row first (with its
gradient, ``parallel.distributed.gather_rows``) and holds its texts'
pairs: rows ``data_rank * B_local * B ...`` of the pairs of the global
batch of B, in the same order. The pure-layout knobs
(``head_major_attention``, ``fused_qkv``, ``proj_impl``) and the kernel
switches (``use_pallas_*``: the CUDA path always runs the kernels) change
no parameter and no arithmetic and are ignored.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.models.coattention import ConnectionLayer
from vilbert_tpu_torch.models.layers import (
    Dropout,
    GeLU,
    ImageLayer,
    LayerNorm,
    Linear,
    TextLayer,
    collect_attention_maps,
    compute_dtype,
    embed,
    param_dtype,
    resolve_act,
)
from vilbert_tpu_torch.ops.attention import make_additive_mask
from vilbert_tpu_torch.parallel.distributed import gather_rows, process_shard


def replay_contexts(generator: Optional[torch.Generator]) -> tuple:
    """``torch.utils.checkpoint``'s ``context_fn`` for a block whose dropout
    sites draw their seeds from ``generator``: (forward, recompute) contexts
    that start the recompute where the generator stood when the block's
    forward began, so that it draws the same seeds, and put the generator
    back after. (The checkpoint's ``preserve_rng_state`` covers torch's
    global generators, not this one.)"""
    if generator is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    start = generator.get_state()

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(start)
        try:
            yield
        finally:
            generator.set_state(now)

    return contextlib.nullcontext(), recompute()


def set_pair_mesh(model: nn.Module, mesh) -> nn.Module:
    """The mesh over whose data rows ``in_batch_pairs`` pairs the texts of
    every ``TwoStreamEncoder`` of ``model`` with the images (None: this
    process's batch alone)."""
    for m in model.modules():
        if isinstance(m, TwoStreamEncoder):
            m.pair_mesh = mesh
    return model


class TextEmbeddings(nn.Module):
    """Word + position + type embeddings, optional task token, LN — summed in
    fp32, normalised in the tables' dtype, cast to the compute dtype at the
    end (reference BertEmbeddings)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        pdtype = param_dtype(cfg)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=pdtype)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                                dtype=pdtype)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                                  dtype=pdtype)
        if cfg.task_specific_tokens:
            self.task_embeddings = nn.Embedding(cfg.num_task_tokens, cfg.hidden_size,
                                                dtype=pdtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, dtype=pdtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, task_ids=None) -> torch.Tensor:
        # positions from arange for both model types (the reference's RoBERTa
        # offset is dead code, see the JAX TextEmbeddings)
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        emb = (
            self.word_embeddings(input_ids.long()).float()
            + self.position_embeddings(positions).float()[None]
            + embed(self.token_type_embeddings, token_type_ids).float()
        )
        if self.cfg.task_specific_tokens:
            if task_ids is None:
                raise ValueError("task_ids required with task_specific_tokens")
            task_emb = self.task_embeddings(task_ids.long()).float()  # [B, 1, H]
            emb = torch.cat([emb[:, :1], task_emb, emb[:, 1:]], dim=1)
        # summed in fp32 and rounded once to the tables' dtype (bf16 tables
        # under bf16 gradients), as XLA fuses the JAX sum before its LN
        emb = emb.to(self.word_embeddings.weight.dtype)
        emb = self.dropout(self.LayerNorm(emb))
        return emb.to(compute_dtype(self.cfg))


class ImageEmbeddings(nn.Module):
    """Region feature + box geometry embeddings, LN (reference
    BertImageEmbeddings); the projections run in the compute dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.image_embeddings = Linear(cfg, cfg.v_feature_size, cfg.v_hidden_size)
        self.image_location_embeddings = Linear(cfg, cfg.num_locs, cfg.v_hidden_size)
        self.LayerNorm = LayerNorm(cfg.v_hidden_size, dtype=param_dtype(cfg))
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, features, locations) -> torch.Tensor:
        emb = self.image_embeddings(features) + self.image_location_embeddings(locations)
        return self.dropout(self.LayerNorm(emb)).to(compute_dtype(self.cfg))


class TwoStreamEncoder(nn.Module):
    """Interleaved text / image / co-attention layers driven by
    ``cfg.encoder_schedule()`` (reference BertEncoder)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        # the dropout sites' generator (set_dropout_generator), which remat
        # replays
        self.dropout_generator: Optional[torch.Generator] = None
        #: the mesh whose data rows in_batch_pairs pairs across (set_pair_mesh)
        self.pair_mesh = None
        self.layer = nn.ModuleList(TextLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.v_layer = nn.ModuleList(ImageLayer(cfg) for _ in range(cfg.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(
            ConnectionLayer(cfg) for _ in range(cfg.num_connection_layers)
        )

    def _block(self, layer: nn.Module, *args):
        """layer(*args); under ``cfg.remat`` with gradients on, through a
        non-reentrant ``torch.utils.checkpoint`` that keeps only the block's
        inputs and recomputes it in the backward (the JAX ``nn.remat``)."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return layer(*args)
        gen = self.dropout_generator
        return checkpoint(layer, *args, use_reentrant=False,
                          context_fn=lambda: replay_contexts(gen))

    def forward(self, txt, img, bias_t, txt_mask2, bias_v) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        expanded = False
        for kind, idx in cfg.encoder_schedule():
            if kind == "t":
                txt = self._block(self.layer[idx], txt, bias_t)
                if idx < cfg.fixed_t_layer:
                    txt = txt.detach()
            elif kind == "v":
                img = self._block(self.v_layer[idx], img, bias_v, txt, txt_mask2)
                if idx < cfg.fixed_v_layer:
                    img = img.detach()
            else:
                if not expanded:
                    txt, img, bias_t, txt_mask2, bias_v = self._expand(
                        txt, img, bias_t, txt_mask2, bias_v)
                    expanded = True
                img, txt = self._block(self.c_layer[idx], img, bias_v, txt, bias_t)
        return txt, img


    def _expand(self, txt, img, bias_t, txt_mask2, bias_v):
        """The in_batch_pairs B^2 expansion, then the fast_mode broadcast,
        applied once before the first connection layer (reference
        vilbert.py:1008-1053, the JAX ``maybe_expand``). Over several data
        rows the images are every row's; under fast_mode the one text is
        every rank's own, and each rank pairs it with its own images. In a
        process group of several ranks the mesh must be set: a rank never
        pairs within its own batch by default."""
        if self.cfg.in_batch_pairs:
            mesh = self.pair_mesh
            if mesh is None and not self.cfg.fast_mode and process_shard()[1] > 1:
                raise ValueError(
                    "in_batch_pairs in a process group of several ranks pairs across the data "
                    "axis: set_pair_mesh(model, mesh) first (run_pretraining and "
                    "MultiTaskTrainer set it from their mesh)")
            if mesh is not None and mesh.data_size > 1 and not self.cfg.fast_mode:
                img = gather_rows(img, mesh.data_group)
                bias_v = gather_rows(bias_v, mesh.data_group)
            # row index = text sample, column index = image sample
            bt, bi = txt.shape[0], img.shape[0]
            img, bias_v = img.repeat(bt, 1, 1), bias_v.repeat(bt, 1, 1, 1)
            txt, bias_t, txt_mask2 = (t.repeat_interleave(bi, dim=0)
                                      for t in (txt, bias_t, txt_mask2))
        if self.cfg.fast_mode:
            # one text row per image (reference FAST_MODE); the text stream
            # is materialised because LN kernels take contiguous rows
            bv = img.shape[0]
            txt = txt.expand(bv, -1, -1).contiguous()
            bias_t = bias_t.expand(bv, -1, -1, -1)
            txt_mask2 = txt_mask2.expand(bv, -1, -1)
        return txt, img, bias_t, txt_mask2, bias_v


class Pooler(nn.Module):
    """First-token pooling: dense -> ReLU (reference BertTextPooler /
    BertImagePooler)."""

    def __init__(self, cfg: ModelConfig, hidden_size: int):
        super().__init__()
        self.dense = Linear(cfg, hidden_size, cfg.bi_hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return F.relu(self.dense(hidden_states[:, 0]))


class BertModelOutput(NamedTuple):
    sequence_t: torch.Tensor
    sequence_v: torch.Tensor
    pooled_t: torch.Tensor
    pooled_v: torch.Tensor
    #: under visualization, {name: probabilities} (``collect_attention_maps``)
    attention_probs: Optional[Dict[str, torch.Tensor]] = None


class BertModel(nn.Module):
    """Full two-stream encoder (reference BertModel)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        self.v_embeddings = ImageEmbeddings(cfg)
        self.encoder = TwoStreamEncoder(cfg)
        self.t_pooler = Pooler(cfg, cfg.hidden_size)
        self.v_pooler = Pooler(cfg, cfg.v_hidden_size)

    def forward(
        self,
        input_txt: torch.Tensor,              # [B, T] token ids
        input_imgs: torch.Tensor,             # [B, R, v_feature_size]
        image_loc: torch.Tensor,              # [B, R, num_locs]
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,        # [B, T] {0,1}
        image_attention_mask: Optional[torch.Tensor] = None,  # [B, R] {0,1}
        co_attention_mask: Optional[torch.Tensor] = None,     # accepted, inert
        task_ids: Optional[torch.Tensor] = None,              # [B, 1]
    ) -> BertModelOutput:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_txt)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_txt)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                input_imgs.shape[:2], dtype=input_txt.dtype, device=input_txt.device
            )
        if self.cfg.task_specific_tokens:
            # one always-valid key position for the task token
            ones = attention_mask.new_ones(attention_mask.shape[0], 1)
            attention_mask = torch.cat([ones, attention_mask], dim=1)

        bias_t = make_additive_mask(attention_mask)
        bias_v = make_additive_mask(image_attention_mask)
        txt_mask2 = attention_mask.to(torch.float32)[:, :, None]

        emb_t = self.embeddings(input_txt, token_type_ids, task_ids)
        emb_v = self.v_embeddings(input_imgs, image_loc)
        with collect_attention_maps(self) as maps:
            seq_t, seq_v = self.encoder(emb_t, emb_v, bias_t, txt_mask2, bias_v)
        return BertModelOutput(seq_t, seq_v, self.t_pooler(seq_t), self.v_pooler(seq_v), maps)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


class PredictionHeadTransform(nn.Module):
    """dense -> act -> LN (reference BertPredictionHeadTransform)."""

    def __init__(self, cfg: ModelConfig, hidden_size: int):
        super().__init__()
        self.dense = Linear(cfg, hidden_size, hidden_size)
        self.act = resolve_act(cfg.hidden_act, cfg)
        self.LayerNorm = LayerNorm(hidden_size, dtype=param_dtype(cfg))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.act(self.dense(h)))


class LMPredictionHead(nn.Module):
    """Transform + tied decoder (the word-embedding table, passed in) + bias."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.transform = PredictionHeadTransform(cfg, cfg.hidden_size)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, dtype=param_dtype(cfg)))

    def forward(self, h: torch.Tensor, embedding_table: torch.Tensor) -> torch.Tensor:
        h = self.transform(h)
        out = compute_dtype(self.cfg)
        logits = (h @ embedding_table.to(h.dtype).T).to(out)
        return logits + self.bias.to(out)


class ImagePredictionHead(nn.Module):
    """Transform + decoder to v_target_size (reference BertImagePredictionHead)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.transform = PredictionHeadTransform(cfg, cfg.v_hidden_size)
        self.decoder = Linear(cfg, cfg.v_hidden_size, cfg.v_target_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(h))


class PreTrainingHeads(nn.Module):
    """MLM + alignment + masked-region heads; pooled outputs fuse by sum or
    product (reference BertPreTrainingHeads)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = LMPredictionHead(cfg)
        self.bi_seq_relationship = Linear(cfg, cfg.bi_hidden_size, 2)
        self.imagePredictions = ImagePredictionHead(cfg)
        self.dropout = Dropout(0.1)

    def fuse(self, pooled_t: torch.Tensor, pooled_v: torch.Tensor) -> torch.Tensor:
        if self.cfg.fusion_method == "sum":
            return self.dropout(pooled_t + pooled_v)
        return self.dropout(pooled_t * pooled_v)

    def forward(self, sequence_t, sequence_v, pooled_t, pooled_v, embedding_table):
        pooled = self.fuse(pooled_t, pooled_v)
        scores_t = self.predictions(sequence_t, embedding_table)
        scores_v = self.imagePredictions(sequence_v)
        return scores_t, scores_v, self.bi_seq_relationship(pooled).float()


class SimpleClassifier(nn.Module):
    """Linear -> GeLU (exact) -> LN -> Linear, fp32 logits (reference
    SimpleClassifier; ``logit_fc`` indices are the reference's)."""

    def __init__(self, cfg: ModelConfig, in_dim: int, hid_dim: int, out_dim: int):
        super().__init__()
        self.logit_fc = nn.Sequential(
            Linear(cfg, in_dim, hid_dim), GeLU(), LayerNorm(hid_dim, dtype=param_dtype(cfg)),
            Linear(cfg, hid_dim, out_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit_fc(x).float()


# ---------------------------------------------------------------------------
# Top-level model
# ---------------------------------------------------------------------------

#: All head names of the VL-tasks model, reference order.
ALL_HEADS = (
    "vil_prediction",
    "vil_prediction_gqa",
    "vil_logit",
    "vil_binary_prediction",
    "vil_tri_prediction",
    "vision_prediction",
    "vision_logit",
    "linguisic_prediction",
    "linguisic_logit",
)


class VLTaskOutput(NamedTuple):
    vil_prediction: Any = None
    vil_prediction_gqa: Any = None
    vil_logit: Any = None
    vil_binary_prediction: Any = None
    vil_tri_prediction: Any = None
    vision_prediction: Any = None
    vision_logit: Any = None
    linguisic_prediction: Any = None
    linguisic_logit: Any = None
    #: under visualization, {name: probabilities}, names from the model's
    #: root (``bert.encoder...``)
    attention_probs: Any = None


def init_weights(model: nn.Module, cfg: ModelConfig, generator: torch.Generator) -> None:
    """The JAX package's initialisation: Linear weights and embedding tables
    ~ N(0, initializer_range), biases 0, LayerNorm (1, 0). Draws in module
    order from ``generator``, so one seed gives one model on every device."""
    std = cfg.initializer_range
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            if isinstance(m, Linear):
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LMPredictionHead):
                m.bias.zero_()


class PretrainOutput(NamedTuple):
    prediction_scores_t: torch.Tensor   # [B, T, vocab] (or [B, K, vocab] gathered)
    prediction_scores_v: torch.Tensor   # [B, R, v_target_size] (or [B, K, ...])
    seq_relationship_score: torch.Tensor  # [B, 2] fp32
    pooled_t: torch.Tensor
    pooled_v: torch.Tensor
    #: under visualization, {name: probabilities} from the model's root
    attention_probs: Optional[Dict[str, torch.Tensor]] = None


class ViLBERTForPretraining(nn.Module):
    """Masked multimodal pretraining model (``vilbert_tpu/models/vilbert.py::
    ViLBERTForPretraining``, reference BertForMultiModalPreTraining). Returns
    logits; the three losses are ``train.losses.pretrain_losses``.

    ``lm_positions`` [B, K] projects only those text rows through the LM head
    (tied to the word-embedding table) and ``img_positions`` [B, K] only
    those image rows through the image head, as the JAX model gathers them.
    """

    #: the parameter names' family (``core.weights``)
    family = "vilbert"

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.cls = PreTrainingHeads(cfg)
        init_weights(self, cfg, generator or torch.Generator().manual_seed(0))

    def forward(
        self,
        input_ids: torch.Tensor,
        image_feat: torch.Tensor,
        image_loc: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        image_attention_mask: Optional[torch.Tensor] = None,
        *,
        lm_positions: Optional[torch.Tensor] = None,
        img_positions: Optional[torch.Tensor] = None,
    ) -> PretrainOutput:
        with collect_attention_maps(self) as maps:
            out = self.bert(input_ids, image_feat, image_loc, token_type_ids,
                            attention_mask, image_attention_mask)
        sequence_t, sequence_v = out.sequence_t, out.sequence_v
        if lm_positions is not None:
            sequence_t = torch.take_along_dim(sequence_t, lm_positions.long()[:, :, None], dim=1)
        if img_positions is not None:
            sequence_v = torch.take_along_dim(sequence_v, img_positions.long()[:, :, None], dim=1)
        scores_t, scores_v, seq_rel = self.cls(
            sequence_t, sequence_v, out.pooled_t, out.pooled_v,
            self.bert.embeddings.word_embeddings.weight,
        )
        return PretrainOutput(scores_t, scores_v, seq_rel, out.pooled_t, out.pooled_v,
                              maps)


class ViLBERTForVLTasks(nn.Module):
    """Fine-tuning model with the task heads (reference VILBertForVLTasks).

    ``generator`` seeds the initialisation (CPU draws; move the model with
    ``.to(device)``). ``heads=`` in ``forward`` selects the heads to compute.
    """

    #: the parameter names' family (``core.weights``)
    family = "vilbert"

    def __init__(self, cfg: ModelConfig, num_labels: int = 3129,
                 num_labels_gqa: int = 1533, dropout_prob: float = 0.1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bi = cfg.bi_hidden_size
        self.bert = BertModel(cfg)
        self.cls = PreTrainingHeads(cfg)
        self.dropout = Dropout(dropout_prob)
        self.vil_prediction = SimpleClassifier(cfg, bi, bi * 2, num_labels)
        self.vil_prediction_gqa = SimpleClassifier(cfg, bi, bi * 2, num_labels_gqa)
        self.vil_binary_prediction = SimpleClassifier(cfg, bi * 2, bi * 2, 2)
        self.vil_logit = Linear(cfg, bi, 1)
        self.vil_tri_prediction = Linear(cfg, bi, 3)
        self.vision_logit = Linear(cfg, cfg.v_hidden_size, 1)
        self.linguisic_logit = Linear(cfg, cfg.hidden_size, 1)
        init_weights(self, cfg, generator or torch.Generator().manual_seed(0))

    def forward(
        self,
        input_txt: torch.Tensor,
        input_imgs: torch.Tensor,
        image_loc: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        image_attention_mask: Optional[torch.Tensor] = None,
        co_attention_mask: Optional[torch.Tensor] = None,
        task_ids: Optional[torch.Tensor] = None,
        *,
        heads: Optional[Sequence[str]] = None,
    ) -> VLTaskOutput:
        heads = set(ALL_HEADS if heads is None else heads)
        with collect_attention_maps(self) as maps:
            out = self.bert(
                input_txt, input_imgs, image_loc, token_type_ids, attention_mask,
                image_attention_mask, co_attention_mask, task_ids,
            )
        results: Dict[str, Any] = {}
        if {"vision_prediction", "linguisic_prediction", "vil_binary_prediction"} & heads:
            scores_t, scores_v, _ = self.cls(
                out.sequence_t, out.sequence_v, out.pooled_t, out.pooled_v,
                self.bert.embeddings.word_embeddings.weight,
            )
            results["linguisic_prediction"] = scores_t
            results["vision_prediction"] = scores_v

        pooled = self.cls.fuse(out.pooled_t, out.pooled_v).to(compute_dtype(self.cfg))
        if "vil_prediction" in heads:
            results["vil_prediction"] = self.vil_prediction(pooled)
        if "vil_prediction_gqa" in heads:
            results["vil_prediction_gqa"] = self.vil_prediction_gqa(pooled)
        if "vil_binary_prediction" in heads and pooled.shape[0] % 2 == 0:
            # consecutive rows are pairs (NLVR2's two images); odd batches
            # skip the head like the reference
            b, h = pooled.shape
            results["vil_binary_prediction"] = self.vil_binary_prediction(
                pooled.reshape(b // 2, h * 2)
            )
        if "vil_logit" in heads:
            results["vil_logit"] = self.vil_logit(pooled).float()
        if "vil_tri_prediction" in heads:
            results["vil_tri_prediction"] = self.vil_tri_prediction(pooled).float()
        if "vision_logit" in heads:
            if image_attention_mask is None:
                image_attention_mask = torch.ones(
                    input_imgs.shape[:2], dtype=input_txt.dtype, device=input_txt.device
                )
            logit = self.vision_logit(self.dropout(out.sequence_v)).float()
            pad = (1.0 - image_attention_mask.to(torch.float32)) * -10000.0
            if logit.shape[0] != pad.shape[0]:
                raise ValueError(
                    f"in_batch_pairs: vision_logit of {logit.shape[0]} (text, image) pairs "
                    f"takes no image mask of {pad.shape[0]} rows (the JAX head fails too)")
            results["vision_logit"] = logit + pad[:, :, None]
        if "linguisic_logit" in heads:
            results["linguisic_logit"] = self.linguisic_logit(
                self.dropout(out.sequence_t)
            ).float()
        return VLTaskOutput(**results, attention_probs=maps)
