"""The single-stream baseline ("BaseBert"), its pretraining model and task
heads, in PyTorch.

Counterpart of ``vilbert_tpu/models/basebert.py`` (reference
vilbert/basebert.py, selected by ``--baseline``): text and image-region
embeddings are concatenated into ONE sequence of T + R tokens and run
through a plain BERT encoder of ``TextLayer``s, the ablation against the
two-stream ViLBERT. As in the JAX package:

- image regions project into ``hidden_size`` and add a token-type
  embedding of type 1;
- the attention mask is the text mask and the image mask concatenated,
  through ``make_additive_mask``;
- one pooler (dense, tanh) reads position 0; the heads read the text and
  image slices of the one sequence;
- ``heads=`` computes only the named heads of the 7; the co-attention mask
  and ``task_ids`` are accepted and ignored. The baseline has no task
  token: a config with ``task_specific_tokens`` is refused (the JAX model
  fails on it at its first call);
- ``int8_matmul`` / ``int8_static`` run every dense site in int8 (the JAX
  baseline's ``_dense`` sites, which the port's ``Linear`` are), and
  ``visualization`` returns each ``TextLayer``'s attention map on the
  output (``attention_probs``); ``remat`` is ignored, as the JAX baseline
  ignores it (its encoder is a plain loop of ``TextLayer``s).

Module names are the reference torch names (``bert.encoder.layer.N``,
``bert.pooler.dense``, ``cls.predictions``, ``cls.imagePredictions``,
``vil_prediction.main.0`` / ``.3``), which
``core.importer._to_flax_key(..., family="basebert")`` maps onto the flax
paths. The text encoder's attention runs K1 (with its in-kernel dropout in
train mode) and K2, every LayerNorm K4, on a CUDA device.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.models.layers import (
    Dropout,
    LayerNorm,
    Linear,
    TextLayer,
    collect_attention_maps,
    compute_dtype,
    embed,
    param_dtype,
)
from vilbert_tpu_torch.models.vilbert import (
    LMPredictionHead,
    PredictionHeadTransform,
    TextEmbeddings,
    init_weights,
)
from vilbert_tpu_torch.ops.attention import make_additive_mask

#: the heads of BaseBertForVLTasks, reference order
BASE_HEADS = (
    "vil_prediction",
    "vil_logit",
    "vil_binary_prediction",
    "vision_prediction",
    "vision_logit",
    "linguisic_prediction",
    "linguisic_logit",
)


class BaseImageEmbeddings(nn.Module):
    """Region features + box geometry + token type into ``hidden_size``, LN
    (reference basebert.py:324-360). The projections return the compute
    dtype and the type embedding the table's, summed with torch's (and
    JAX's) promotion; normalised, then cast to the compute dtype."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.image_embeddings = Linear(cfg, cfg.v_feature_size, cfg.hidden_size)
        self.image_location_embeddings = Linear(cfg, cfg.num_locs, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size,
                                                  dtype=param_dtype(cfg))
        self.LayerNorm = LayerNorm(cfg.hidden_size, dtype=param_dtype(cfg))
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, features, locations, token_type_ids) -> torch.Tensor:
        emb = (self.image_embeddings(features) + self.image_location_embeddings(locations)
               + embed(self.token_type_embeddings, token_type_ids))
        return self.dropout(self.LayerNorm(emb)).to(compute_dtype(self.cfg))


class BaseEncoder(nn.Module):
    """The stack of ``TextLayer``s (reference BertEncoder)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(TextLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, seq: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.layer:
            seq = layer(seq, bias)
        return seq


class BasePooler(nn.Module):
    """tanh(dense(position 0)) (reference BertPooler)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Linear(cfg, cfg.hidden_size, cfg.hidden_size)

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(seq[:, 0]))


class BaseBertModelOutput(NamedTuple):
    sequence: torch.Tensor  # [B, T + R, H]
    pooled: torch.Tensor    # [B, H]
    #: under visualization, {name: probabilities} (``collect_attention_maps``)
    attention_probs: Optional[Dict[str, torch.Tensor]] = None


class BaseBertModel(nn.Module):
    """Single-stream encoder over [text ; image] (reference basebert.py:658-774)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.task_specific_tokens:
            raise ValueError("the single-stream baseline takes no task token: its embeddings "
                             "get no task ids (set task_specific_tokens=False)")
        self.cfg = cfg
        self.embeddings = TextEmbeddings(cfg)
        self.image_embeddings = BaseImageEmbeddings(cfg)
        self.encoder = BaseEncoder(cfg)
        self.pooler = BasePooler(cfg)

    def forward(
        self,
        input_txt: torch.Tensor,              # [B, T] token ids
        input_imgs: torch.Tensor,             # [B, R, v_feature_size]
        image_loc: torch.Tensor,              # [B, R, num_locs]
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,        # [B, T] {0,1}
        image_attention_mask: Optional[torch.Tensor] = None,  # [B, R] {0,1}
    ) -> BaseBertModelOutput:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_txt)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_txt)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                input_imgs.shape[:2], dtype=input_txt.dtype, device=input_txt.device)
        image_types = torch.ones(input_imgs.shape[:2], dtype=torch.long, device=input_txt.device)
        seq = torch.cat([self.embeddings(input_txt, token_type_ids),
                         self.image_embeddings(input_imgs, image_loc, image_types)], dim=1)
        bias = make_additive_mask(torch.cat(
            [attention_mask.to(torch.int32), image_attention_mask.to(torch.int32)], dim=1))
        with collect_attention_maps(self) as maps:
            seq = self.encoder(seq, bias)
        return BaseBertModelOutput(seq, self.pooler(seq), maps)


class BaseImagePredictionHead(nn.Module):
    """Transform + decoder to v_target_size at ``hidden_size`` (the
    reference's ``cls.imagePredictions``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.transform = PredictionHeadTransform(cfg, cfg.hidden_size)
        self.decoder = Linear(cfg, cfg.hidden_size, cfg.v_target_size)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform(h)).float()


class BasePreTrainingHeads(nn.Module):
    """MLM (tied), alignment and masked-region heads of the baseline
    (reference ``cls``); applied piecewise by the models."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.predictions = LMPredictionHead(cfg)
        self.seq_relationship = Linear(cfg, cfg.hidden_size, 2)
        self.imagePredictions = BaseImagePredictionHead(cfg)


class BasePretrainOutput(NamedTuple):
    prediction_scores_t: torch.Tensor   # [B, T, vocab] (or [B, K, vocab] gathered)
    prediction_scores_v: torch.Tensor   # [B, R, v_target_size] fp32 (or [B, K, ...])
    seq_relationship_score: torch.Tensor  # [B, 2] fp32
    #: under visualization, {name: probabilities} from the model's root
    attention_probs: Optional[Dict[str, torch.Tensor]] = None


class BaseBertForPretraining(nn.Module):
    """Single-stream pretraining (``vilbert_tpu/models/basebert.py::
    BaseBertForPretraining``, reference basebert.py:777-891); returns
    logits, the losses are ``train.losses.pretrain_losses``.
    ``lm_positions`` / ``img_positions`` [B, K] project only those text /
    image rows through the LM and image heads."""

    #: the parameter names' family (``core.weights``)
    family = "basebert"

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.bert = BaseBertModel(cfg)
        self.cls = BasePreTrainingHeads(cfg)
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
    ) -> BasePretrainOutput:
        with collect_attention_maps(self) as maps:
            out = self.bert(input_ids, image_feat, image_loc, token_type_ids, attention_mask,
                            image_attention_mask)
        t_len = input_ids.shape[1]
        seq_t, seq_v = out.sequence[:, :t_len], out.sequence[:, t_len:]
        if lm_positions is not None:
            seq_t = torch.take_along_dim(seq_t, lm_positions.long()[:, :, None], dim=1)
        if img_positions is not None:
            seq_v = torch.take_along_dim(seq_v, img_positions.long()[:, :, None], dim=1)
        heads = self.cls
        return BasePretrainOutput(
            heads.predictions(seq_t, self.bert.embeddings.word_embeddings.weight),
            heads.imagePredictions(seq_v),
            heads.seq_relationship(out.pooled).float(),
            maps,
        )


class BaseVLTaskOutput(NamedTuple):
    vil_prediction: Any = None
    vil_logit: Any = None
    vil_binary_prediction: Any = None
    vision_prediction: Any = None
    vision_logit: Any = None
    linguisic_prediction: Any = None
    linguisic_logit: Any = None
    #: under visualization, {name: probabilities} from the model's root
    attention_probs: Any = None


class BaseSimpleClassifier(nn.Module):
    """Linear -> ReLU -> dropout -> Linear, fp32 logits (reference
    basebert.py:965-978, whose weight norm folds into the weights at
    import); ``main.0`` and ``main.3`` are the reference's indices."""

    def __init__(self, cfg: ModelConfig, in_dim: int, hid_dim: int, out_dim: int,
                 dropout_prob: float):
        super().__init__()
        self.main = nn.Sequential(Linear(cfg, in_dim, hid_dim), nn.ReLU(),
                                  Dropout(dropout_prob), Linear(cfg, hid_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x).float()


class BaseBertForVLTasks(nn.Module):
    """Single-stream task model with the reference's 7 heads
    (``vilbert_tpu/models/basebert.py::BaseBertForVLTasks``, reference
    basebert.py:893-962). ``heads=`` in ``forward`` selects the heads to
    compute; ``co_attention_mask`` and ``task_ids`` are accepted and
    ignored."""

    #: the parameter names' family (``core.weights``)
    family = "basebert"

    def __init__(self, cfg: ModelConfig, num_labels: int = 3129, dropout_prob: float = 0.1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.bert = BaseBertModel(cfg)
        self.cls = BasePreTrainingHeads(cfg)
        self.dropout = Dropout(dropout_prob)
        self.vil_prediction = BaseSimpleClassifier(cfg, h, 2 * h, num_labels, dropout_prob)
        self.vil_logit = Linear(cfg, h, 1)
        self.vision_logit = Linear(cfg, h, 1)
        self.linguisic_logit = Linear(cfg, h, 1)
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
    ) -> BaseVLTaskOutput:
        heads = set(BASE_HEADS if heads is None else heads)
        if image_attention_mask is None:
            image_attention_mask = torch.ones(
                input_imgs.shape[:2], dtype=input_txt.dtype, device=input_txt.device)
        with collect_attention_maps(self) as maps:
            out = self.bert(input_txt, input_imgs, image_loc, token_type_ids, attention_mask,
                            image_attention_mask)
        t_len = input_txt.shape[1]
        seq_t, seq_v = out.sequence[:, :t_len], out.sequence[:, t_len:]
        results: Dict[str, Any] = {}
        if "linguisic_prediction" in heads:
            results["linguisic_prediction"] = self.cls.predictions(
                seq_t, self.bert.embeddings.word_embeddings.weight)
        if "vision_prediction" in heads:
            results["vision_prediction"] = self.cls.imagePredictions(seq_v)
        if "vil_binary_prediction" in heads:
            results["vil_binary_prediction"] = self.cls.seq_relationship(out.pooled).float()
        if "vil_prediction" in heads:
            results["vil_prediction"] = self.vil_prediction(out.pooled)
        if "vil_logit" in heads:
            results["vil_logit"] = self.vil_logit(out.pooled).float()
        if "vision_logit" in heads:
            pad = (1.0 - image_attention_mask.to(torch.float32)) * -10000.0
            results["vision_logit"] = (self.vision_logit(self.dropout(seq_v)).float()
                                       + pad[:, :, None])
        if "linguisic_logit" in heads:
            results["linguisic_logit"] = self.linguisic_logit(self.dropout(seq_t)).float()
        return BaseVLTaskOutput(**results, attention_probs=maps)
