"""The plain ViLBERT and single-stream baseline, forward in float32.

Modules carry the reference ``state_dict`` names (``bert.encoder.layer.N
.attention.self.query``, ``bert.encoder.c_layer.N.biattention.query1``,
``cls.predictions.bias``, ``vil_prediction.logit_fc.0`` ...). Every
dropout site draws one seed per call, in forward order, from the CPU
generator handed to the model (``Net.dropout_generator``); attention draws
its seed before the probabilities, a connection layer draws the text-query
direction's first.

``precision="fp8"`` (the control) runs every product (dense, attention
scores and context, the tied LM decoder) on float8 operands: e4m3 forward,
e5m2 cotangents, one scale a tensor (amax / the format's largest), sums in
float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from reference.dropout import attention_keep_mask, draw_seed, keep_mask

#: BertConfig defaults of the reference (vilbert/vilbert.py), for keys a
#: configuration file leaves out
DEFAULTS = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
    max_position_embeddings=512, type_vocab_size=2, v_feature_size=2048, v_target_size=1601,
    v_hidden_size=768, v_num_hidden_layers=3, v_num_attention_heads=12,
    v_intermediate_size=3072, v_attention_probs_dropout_prob=0.1, v_hidden_dropout_prob=0.1,
    num_locs=5, bi_hidden_size=1024, bi_num_attention_heads=16, v_biattention_id=(0, 1),
    t_biattention_id=(10, 11), fusion_method="mul", task_specific_tokens=False,
    num_task_tokens=20,
)


class Config:
    """The sizes of a configuration file, over ``DEFAULTS``."""

    def __init__(self, sizes: Dict, **overrides):
        values = {**DEFAULTS, **{k: v for k, v in sizes.items() if k in DEFAULTS}, **overrides}
        for k, v in values.items():
            setattr(self, k, tuple(v) if isinstance(v, list) else v)

    def schedule(self) -> List[Tuple[str, int]]:
        """The reference BertEncoder's interleave: for connection i, the text
        layers up to t_biattention_id[i], the image layers up to
        v_biattention_id[i], then connection i; then the trailing image and
        text layers."""
        ops, v0, t0 = [], 0, 0
        for i, (v1, t1) in enumerate(zip(self.v_biattention_id, self.t_biattention_id)):
            ops += [("t", j) for j in range(t0, t1)] + [("v", j) for j in range(v0, v1)]
            ops.append(("c", i))
            v0, t0 = v1, t1
        ops += [("v", j) for j in range(v0, self.v_num_hidden_layers)]
        ops += [("t", j) for j in range(t0, self.num_hidden_layers)]
        return ops


# -- float8 products (the control) -------------------------------------------


def _q8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _q8(g, torch.float8_e5m2)
        ga, gb = gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq
        # broadcast operands (a weight against a batch) sum their gradient
        while gb.dim() > bq.dim():
            gb = gb.sum(0)
        return ga, gb


class Net(nn.Module):
    """Root of a reference model: holds the dropout generator and the
    precision that every site reads.

    A step may run in blocks of rows (``rows_from``): the first block draws
    the step's dropout seeds, the others replay them, and every mask is
    taken at the block's place in the whole batch, so the blocks' masks
    are the whole batch's."""

    def __init__(self, precision: str):
        super().__init__()
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"
        self.dropout_generator: Optional[torch.Generator] = None
        self.row = 0
        self._drawn: Optional[List[int]] = None
        self._replay = None

    def rows_from(self, row: int) -> None:
        """The next forward computes rows ``row ...`` of the step's batch: at
        row 0 it draws (and keeps) the step's seeds, past it replays them."""
        self.row = row
        if row == 0:
            self._drawn, self._replay = [], None
        else:
            self._replay = iter(self._drawn)

    def bind(self) -> None:
        for m in self.modules():
            if m is not self:
                m.__dict__["root"] = self  # not a submodule: no second path in named_modules

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def seed(self) -> int:
        if self._replay is not None:
            return next(self._replay)
        if self.dropout_generator is None:
            raise ValueError("training-mode dropout needs dropout_generator")
        seed = draw_seed(self.dropout_generator)
        if self._drawn is not None:
            self._drawn.append(seed)
        return seed


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        return self.root.mm(x, self.weight.t()) + self.bias


class LayerNorm(nn.Module):
    def __init__(self, n: int, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = keep_mask(x.shape, self.rate, self.root.seed(), device=x.device,
                         offset=self.root.row * x[0].numel())
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0, 1} -> [B, S] float bias: 0 where valid, -10000 elsewhere."""
    return (1.0 - mask.float()) * -10000.0


class _Attend(nn.Module):
    """Multi-head attention core of a site: softmax(q k^T / sqrt(d) + key
    bias), dropout on the probabilities, then the product with v."""

    def attend(self, q, k, v, bias, heads: int, rate: float):
        b, sq, width = q.shape
        sk, d = k.shape[1], width // heads
        split = (lambda t, s: t.reshape(b, s, heads, d).transpose(1, 2))
        mm = self.root.mm
        scores = mm(split(q, sq), split(k, sk).transpose(-1, -2)) / math.sqrt(d)
        p = torch.softmax(scores + bias[:, None, None, :], dim=-1)
        if self.training and rate > 0.0:
            keep = attention_keep_mask(b, heads, sq, sk, rate, self.root.seed(), device=q.device,
                                       row=self.root.row)
            p = torch.where(keep, p / (1.0 - rate), 0.0)
        return mm(p, split(v, sk)).transpose(1, 2).reshape(b, sq, width)


class SelfAttention(_Attend):
    def __init__(self, width: int, heads: int, rate: float):
        super().__init__()
        self.heads, self.rate = heads, rate
        self.query, self.key, self.value = (Linear(width, width) for _ in range(3))

    def forward(self, x, bias):
        return self.attend(self.query(x), self.key(x), self.value(x), bias, self.heads,
                           self.rate)


class AttentionOutput(nn.Module):
    def __init__(self, width: int, rate: float):
        super().__init__()
        self.dense = Linear(width, width)
        self.LayerNorm = LayerNorm(width)
        self.dropout = Dropout(rate)

    def forward(self, h, x):
        return self.LayerNorm(self.dropout(self.dense(h)) + x)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int, attn_rate: float, rate: float):
        super().__init__()
        self.self = SelfAttention(width, heads, attn_rate)
        self.output = AttentionOutput(width, rate)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class Intermediate(nn.Module):
    def __init__(self, width: int, inner: int):
        super().__init__()
        self.dense = Linear(width, inner)

    def forward(self, x):
        return gelu(self.dense(x))


class Output(nn.Module):
    def __init__(self, inner: int, width: int, rate: float):
        super().__init__()
        self.dense = Linear(inner, width)
        self.LayerNorm = LayerNorm(width)
        self.dropout = Dropout(rate)

    def forward(self, h, x):
        return self.LayerNorm(self.dropout(self.dense(h)) + x)


class Layer(nn.Module):
    """One transformer block (BertLayer, BertImageLayer)."""

    def __init__(self, width, heads, inner, attn_rate, rate):
        super().__init__()
        self.attention = Attention(width, heads, attn_rate, rate)
        self.intermediate = Intermediate(width, inner)
        self.output = Output(inner, width, rate)

    def forward(self, x, bias):
        a = self.attention(x, bias)
        return self.output(self.intermediate(a), a)


def text_layer(c: Config) -> Layer:
    return Layer(c.hidden_size, c.num_attention_heads, c.intermediate_size,
                 c.attention_probs_dropout_prob, c.hidden_dropout_prob)


def image_layer(c: Config) -> Layer:
    return Layer(c.v_hidden_size, c.v_num_attention_heads, c.v_intermediate_size,
                 c.v_attention_probs_dropout_prob, c.v_hidden_dropout_prob)


class BiAttention(_Attend):
    """Co-attention (BertBiAttention): text queries over image keys at the
    image stream's attention rate, image queries over text keys at the
    text stream's."""

    def __init__(self, c: Config):
        super().__init__()
        bi = c.bi_hidden_size
        self.heads = c.bi_num_attention_heads
        self.rate_t, self.rate_v = c.v_attention_probs_dropout_prob, c.attention_probs_dropout_prob
        self.query1, self.key1, self.value1 = (Linear(c.v_hidden_size, bi) for _ in range(3))
        self.query2, self.key2, self.value2 = (Linear(c.hidden_size, bi) for _ in range(3))

    def forward(self, xv, bias_v, xt, bias_t):
        ctx_t = self.attend(self.query2(xt), self.key1(xv), self.value1(xv), bias_v,
                            self.heads, self.rate_t)
        ctx_v = self.attend(self.query1(xv), self.key2(xt), self.value2(xt), bias_t,
                            self.heads, self.rate_v)
        return ctx_v, ctx_t


class BiOutput(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        bi = c.bi_hidden_size
        self.dense1, self.LayerNorm1 = Linear(bi, c.v_hidden_size), LayerNorm(c.v_hidden_size)
        self.dropout1 = Dropout(c.v_hidden_dropout_prob)
        self.dense2, self.LayerNorm2 = Linear(bi, c.hidden_size), LayerNorm(c.hidden_size)
        self.dropout2 = Dropout(c.hidden_dropout_prob)

    def forward(self, ctx_v, xv, ctx_t, xt):
        return (self.LayerNorm1(self.dropout1(self.dense1(ctx_v)) + xv),
                self.LayerNorm2(self.dropout2(self.dense2(ctx_t)) + xt))


class ConnectionLayer(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.biattention = BiAttention(c)
        self.biOutput = BiOutput(c)
        self.v_intermediate = Intermediate(c.v_hidden_size, c.v_intermediate_size)
        self.v_output = Output(c.v_intermediate_size, c.v_hidden_size, c.v_hidden_dropout_prob)
        self.t_intermediate = Intermediate(c.hidden_size, c.intermediate_size)
        self.t_output = Output(c.intermediate_size, c.hidden_size, c.hidden_dropout_prob)

    def forward(self, xv, bias_v, xt, bias_t):
        ctx_v, ctx_t = self.biattention(xv, bias_v, xt, bias_t)
        av, at = self.biOutput(ctx_v, xv, ctx_t, xt)
        return (self.v_output(self.v_intermediate(av), av),
                self.t_output(self.t_intermediate(at), at))


class TextEmbeddings(nn.Module):
    """Word + position + token type, the task token after [CLS], LN, dropout."""

    def __init__(self, c: Config):
        super().__init__()
        self.task_tokens = c.task_specific_tokens
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        if self.task_tokens:
            self.task_embeddings = nn.Embedding(c.num_task_tokens, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, ids, types, task_ids=None):
        pos = torch.arange(ids.shape[1], device=ids.device)
        e = (self.word_embeddings(ids.long()) + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(types.long()))
        if self.task_tokens:
            e = torch.cat([e[:, :1], self.task_embeddings(task_ids.long()), e[:, 1:]], dim=1)
        return self.dropout(self.LayerNorm(e))


class ImageEmbeddings(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.image_embeddings = Linear(c.v_feature_size, c.v_hidden_size)
        self.image_location_embeddings = Linear(c.num_locs, c.v_hidden_size)
        self.LayerNorm = LayerNorm(c.v_hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, feats, locs):
        e = self.image_embeddings(feats.float()) + self.image_location_embeddings(locs.float())
        return self.dropout(self.LayerNorm(e))


class Encoder(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.plan = c.schedule()
        self.layer = nn.ModuleList(text_layer(c) for _ in range(c.num_hidden_layers))
        self.v_layer = nn.ModuleList(image_layer(c) for _ in range(c.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(ConnectionLayer(c) for _ in c.v_biattention_id)

    def forward(self, t, v, bias_t, bias_v):
        for kind, i in self.plan:
            if kind == "t":
                t = self.layer[i](t, bias_t)
            elif kind == "v":
                v = self.v_layer[i](v, bias_v)
            else:
                v, t = self.c_layer[i](v, bias_v, t, bias_t)
        return t, v


class Pooler(nn.Module):
    def __init__(self, width: int, bi: int):
        super().__init__()
        self.dense = Linear(width, bi)

    def forward(self, h):
        return F.relu(self.dense(h[:, 0]))


class BertModel(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.task_tokens = c.task_specific_tokens
        self.embeddings = TextEmbeddings(c)
        self.v_embeddings = ImageEmbeddings(c)
        self.encoder = Encoder(c)
        self.t_pooler = Pooler(c.hidden_size, c.bi_hidden_size)
        self.v_pooler = Pooler(c.v_hidden_size, c.bi_hidden_size)

    def forward(self, ids, feats, locs, types, mask, img_mask, task_ids=None):
        if self.task_tokens:
            mask = torch.cat([mask.new_ones(mask.shape[0], 1), mask], dim=1)
        t = self.embeddings(ids, types, task_ids)
        v = self.v_embeddings(feats, locs)
        t, v = self.encoder(t, v, additive_mask(mask), additive_mask(img_mask))
        return t, v, self.t_pooler(t), self.v_pooler(v)


class Transform(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.dense = Linear(width, width)
        self.LayerNorm = LayerNorm(width)

    def forward(self, h):
        return self.LayerNorm(gelu(self.dense(h)))


class LMHead(nn.Module):
    """Transform, then the word-embedding table (tied) and a bias."""

    def __init__(self, c: Config):
        super().__init__()
        self.transform = Transform(c.hidden_size)
        self.bias = nn.Parameter(torch.empty(c.vocab_size))

    def forward(self, h, table):
        return self.root.mm(self.transform(h), table.t()) + self.bias


class ImageHead(nn.Module):
    def __init__(self, width: int, targets: int):
        super().__init__()
        self.transform = Transform(width)
        self.decoder = Linear(width, targets)

    def forward(self, h):
        return self.decoder(self.transform(h))


class PreTrainingHeads(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.sum = c.fusion_method == "sum"
        self.predictions = LMHead(c)
        self.bi_seq_relationship = Linear(c.bi_hidden_size, 2)
        self.imagePredictions = ImageHead(c.v_hidden_size, c.v_target_size)
        self.dropout = Dropout(0.1)

    def fuse(self, pt, pv):
        return self.dropout(pt + pv if self.sum else pt * pv)


def _take(seq, positions):
    if positions is None:
        return seq
    return torch.take_along_dim(seq, positions.long()[:, :, None], dim=1)


class ViLBERTForPretraining(Net):
    def __init__(self, c: Config, precision: str = "fp32"):
        super().__init__(precision)
        self.bert = BertModel(c)
        self.cls = PreTrainingHeads(c)
        self.bind()

    def forward(self, ids, feats, locs, types, mask, img_mask, *, lm_positions=None,
                img_positions=None):
        t, v, pt, pv = self.bert(ids, feats, locs, types, mask, img_mask)
        pooled = self.cls.fuse(pt, pv)
        table = self.bert.embeddings.word_embeddings.weight
        return (self.cls.predictions(_take(t, lm_positions), table),
                self.cls.imagePredictions(_take(v, img_positions)),
                self.cls.bi_seq_relationship(pooled))


class SimpleClassifier(nn.Module):
    def __init__(self, n_in: int, hidden: int, n_out: int):
        super().__init__()
        self.logit_fc = nn.Sequential(Linear(n_in, hidden), _Gelu(), LayerNorm(hidden),
                                      Linear(hidden, n_out))

    def forward(self, x):
        return self.logit_fc(x)


class _Gelu(nn.Module):
    def forward(self, x):
        return gelu(x)


#: the head each task type reads (task_utils.py)
HEAD_FOR_TYPE = {
    "VL-classifier": "vil_prediction", "VL-classifier-GQA": "vil_prediction_gqa",
    "VL-logit": "vil_logit", "V-logit": "vision_logit", "V-logit-mc": "vision_logit",
    "VL-binary-classifier": "vil_binary_prediction", "VL-tri-classifier": "vil_tri_prediction",
}


class ViLBERTForVLTasks(Net):
    """VILBertForVLTasks: the encoder, the pretraining heads and the task heads."""

    def __init__(self, c: Config, num_labels: int = 3129, num_labels_gqa: int = 1533,
                 precision: str = "fp32"):
        super().__init__(precision)
        bi = c.bi_hidden_size
        self.bert = BertModel(c)
        self.cls = PreTrainingHeads(c)
        self.dropout = Dropout(0.1)
        self.vil_prediction = SimpleClassifier(bi, 2 * bi, num_labels)
        self.vil_prediction_gqa = SimpleClassifier(bi, 2 * bi, num_labels_gqa)
        self.vil_binary_prediction = SimpleClassifier(2 * bi, 2 * bi, 2)
        self.vil_logit = Linear(bi, 1)
        self.vil_tri_prediction = Linear(bi, 3)
        self.vision_logit = Linear(c.v_hidden_size, 1)
        self.linguisic_logit = Linear(c.hidden_size, 1)
        self.bind()

    def forward(self, ids, feats, locs, types, mask, img_mask, task_ids=None, *,
                head: str):
        t, v, pt, pv = self.bert(ids, feats, locs, types, mask, img_mask, task_ids)
        if head == "vil_binary_prediction":
            self.cls.fuse(pt, pv)  # the pretraining heads run first and draw their seed
        pooled = self.cls.fuse(pt, pv)
        if head in ("vil_prediction", "vil_prediction_gqa", "vil_logit", "vil_tri_prediction"):
            return getattr(self, head)(pooled)
        if head == "vil_binary_prediction":
            return self.vil_binary_prediction(pooled.reshape(pooled.shape[0] // 2, -1))
        if head == "vision_logit":
            pad = additive_mask(img_mask)
            return self.vision_logit(self.dropout(v)) + pad[:, :, None]
        raise ValueError(head)


class BaseImageEmbeddings(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.image_embeddings = Linear(c.v_feature_size, c.hidden_size)
        self.image_location_embeddings = Linear(c.num_locs, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def forward(self, feats, locs):
        e = (self.image_embeddings(feats.float()) + self.image_location_embeddings(locs.float())
             + self.token_type_embeddings.weight[1])
        return self.dropout(self.LayerNorm(e))


class BaseEncoder(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.layer = nn.ModuleList(text_layer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class BasePooler(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.dense = Linear(width, width)

    def forward(self, h):
        return torch.tanh(self.dense(h[:, 0]))


class BaseBertModel(nn.Module):
    """The single-stream baseline: text and regions as one sequence."""

    def __init__(self, c: Config):
        super().__init__()
        self.embeddings = TextEmbeddings(c)
        self.image_embeddings = BaseImageEmbeddings(c)
        self.encoder = BaseEncoder(c)
        self.pooler = BasePooler(c.hidden_size)

    def forward(self, ids, feats, locs, types, mask, img_mask):
        seq = torch.cat([self.embeddings(ids, types), self.image_embeddings(feats, locs)], dim=1)
        seq = self.encoder(seq, additive_mask(torch.cat([mask, img_mask], dim=1)))
        return seq, self.pooler(seq)


class BasePreTrainingHeads(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.predictions = LMHead(c)
        self.seq_relationship = Linear(c.hidden_size, 2)
        self.imagePredictions = ImageHead(c.hidden_size, c.v_target_size)


class BaseBertForPretraining(Net):
    def __init__(self, c: Config, precision: str = "fp32"):
        super().__init__(precision)
        self.bert = BaseBertModel(c)
        self.cls = BasePreTrainingHeads(c)
        self.bind()

    def forward(self, ids, feats, locs, types, mask, img_mask, *, lm_positions=None,
                img_positions=None):
        seq, pooled = self.bert(ids, feats, locs, types, mask, img_mask)
        t, v = seq[:, :ids.shape[1]], seq[:, ids.shape[1]:]
        table = self.bert.embeddings.word_embeddings.weight
        return (self.cls.predictions(_take(t, lm_positions), table),
                self.cls.imagePredictions(_take(v, img_positions)),
                self.cls.seq_relationship(pooled))


PRETRAINING = {"vilbert": ViLBERTForPretraining, "basebert": BaseBertForPretraining}
