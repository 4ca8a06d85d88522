"""Shared building blocks: activations, Linear/LayerNorm/Dropout modules and
the transformer blocks of both streams.

Counterpart of ``vilbert_tpu/models/layers.py``. Module and parameter names
are the reference torch ``state_dict`` names (``attention.self.query``,
``attention.output.LayerNorm``, ``intermediate.dense``, ``output.dense``),
so ``core.importer._to_flax_key`` maps every parameter of the
port onto its flax path. The JAX ``FeedForward`` is split as the reference
splits it: ``Intermediate`` (dense + activation) then ``Output`` (dense,
dropout, LN with residual).

Dtype policy (as the JAX package): params fp32; every ``Linear`` casts its
input, weight and bias to ``cfg.compute_dtype`` and returns that dtype, like
``flax.linen.Dense(dtype=compute_dtype)``; LayerNorm statistics are fp32.

Int8 (``cfg.int8_matmul``, ``cfg.int8_static``; inference only): every
``Linear`` computes ``ops.quant.int8_dense`` instead, as every ``_dense``,
``HeadProj`` and ``MergeProj`` site of the JAX package does (word
embeddings, LayerNorm and the tied LM decoder stay as they are). A static
site keeps an fp32 ``act_amax`` buffer of its input width, filled under
``ops.quant.calibrating`` (not in the ``state_dict``: ``core.weights``'
``quant_from_model`` and ``load_quant`` move it as flax's ``quant``
collection).

Visualization (``cfg.visualization``): each attention site hands its
probabilities to ``keep_map`` (``attention_probs``; the co-attention's
image-query direction ``attention_probs_v``), as the JAX sites ``sow``
them. The model that is called collects them once, under
``collect_attention_maps``; outside it (a nested model, remat's recompute
in the backward) a site keeps nothing.

Dropout (train mode, rate > 0) is the JAX package's counter-hash dropout:
``hash_dropout`` at the hidden-state sites, the kernels' ``_keep_mask`` in
the attention. Each site draws one uint32 seed per call from the CPU
``torch.Generator`` that ``set_dropout_generator`` hands to every site; the
trainer owns it. In eval mode the attention runs at rate 0.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.ops.attention import attention, attention_ref
from vilbert_tpu_torch.ops.dropout import draw_seed, hash_dropout, shard_seed
# gelu_rational and its coefficients (named as in vilbert_tpu.models.layers)
# live beside its kernels
from vilbert_tpu_torch.ops.gelu import (  # noqa: F401
    _DGELU_P,
    _DGELU_Q,
    _ERF_P,
    _ERF_Q,
    gelu_rational,
)
from vilbert_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref
from vilbert_tpu_torch.ops.quant import int8_dense, static_act_amax


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype every parameter is created in (``cfg.param_dtype``), as the
    JAX modules pass it to each ``param``, ``nn.Dense`` and ``nn.Embed``."""
    return getattr(torch, cfg.param_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu — the reference's non-approximate form."""
    return F.gelu(x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACT2FN: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu,
    "gelu_rational": gelu_rational,
    "relu": F.relu,
    "swish": swish,
}


def resolve_act(name: str, cfg: ModelConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name under the config's gelu_impl policy ("auto": the
    rational erf under bf16 compute, the exact erf under fp32)."""
    if name == "gelu" and cfg.resolved_gelu_impl == "rational":
        return gelu_rational
    return ACT2FN[name]


class Linear(nn.Module):
    """y = x W^T + b in the compute dtype; W [out, in] and b params in
    ``cfg.param_dtype``.

    Under int8 (``int8`` is "dynamic" or "static") the product is
    ``int8_dense`` of x as it comes (``QuantDense`` does not cast it first)
    and the bias is added in the compute dtype; a static site reads its
    range from ``static_act_amax``."""

    def __init__(self, cfg: ModelConfig, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype(cfg)))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=param_dtype(cfg)))
        self.compute_dtype = compute_dtype(cfg)
        self.int8 = "static" if cfg.int8_static else "dynamic" if cfg.int8_matmul else None
        if self.int8 == "static":
            self.register_buffer("act_amax", torch.zeros(in_features), persistent=False)
            self.calibrating = self.calibrated = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.int8 is None:
            return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        amax = static_act_amax(self, x) if self.int8 == "static" else None
        return int8_dense(x, self.weight, dt, amax) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """TF-style LayerNorm (eps 1e-12) with an optional fused residual add.

    Runs ``ops.layernorm.layer_norm`` (the kernel on CUDA); ``plain_ops``
    switches it to the plain version (see ``use_plain_ops``). Weight and
    bias are created in ``dtype`` (the models pass ``param_dtype(cfg)``)."""

    def __init__(self, hidden_size: int, eps: float = 1e-12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(hidden_size, dtype=dtype))
        self.eps = eps
        self.plain_ops = False

    def forward(
        self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        fn = layer_norm_ref if self.plain_ops else layer_norm
        return fn(x, self.weight, self.bias, eps=self.eps, residual=residual)


def site_seed(site: nn.Module) -> int:
    """The next uint32 dropout seed of a dropout site (a module with a
    ``dropout_generator``); raises if no generator was set."""
    if site.dropout_generator is None:
        raise ValueError(
            f"{type(site).__name__}: dropout in train mode draws its seeds from a "
            f"torch.Generator; call set_dropout_generator(model, generator) first"
        )
    return draw_seed(site.dropout_generator)


def embed(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``table(ids)`` for a table of a few rows (the token types), as a
    select among its rows: the same rows forward, and a backward that sums
    each row's gradient by a reduction, in a fixed order, where
    ``nn.Embedding``'s CUDA backward does not over one id repeated through
    the batch (a run then repeats bit for bit). A pass over the output a
    row; larger tables take ``nn.Embedding``, whose backward is faster than
    a sorted ``index_put_`` over many repeats."""
    w = table.weight
    ids = ids.long()[..., None]
    out = w[0].expand(*ids.shape[:-1], w.shape[1])
    for row in range(1, w.shape[0]):
        out = torch.where(ids == row, w[row], out)
    return out


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator], *,
                          rank: int = 0) -> nn.Module:
    """Hand the CPU generator that train-mode dropout draws its seeds from to
    every dropout site of ``model`` (None removes it). ``rank``: this
    process's data row of a mesh (``Mesh.data_rank``), whose masks are
    then its rows' of the global batch's (``ops.dropout``: the flat offset
    and the attention seed shift)."""
    for m in model.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator
            m.dropout_rank = rank
    return model


class Dropout(nn.Module):
    """Identity in eval mode or at rate 0. In train mode, counter-hash
    dropout (``hash_dropout``, bit-exact with
    ``vilbert_tpu/ops/dropout.py::hash_dropout`` for the same seed) with one
    seed per call from the site's generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.dropout_generator: Optional[torch.Generator] = None
        self.dropout_rank = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        # rank r's rows of the global batch start at flat index r * numel
        return hash_dropout(x, self.rate, site_seed(self), offset=self.dropout_rank * x.numel())


class GeLU(nn.Module):
    """Exact gelu as a module (reference ``GeLU`` inside SimpleClassifier)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


def attend(site: nn.Module, q, k, v, bias, num_heads: int, rate: float,
           return_probs: bool = False):
    """The attention of a site (a module with ``plain_ops`` and a
    ``dropout_generator``): ``attention`` at ``rate`` with a drawn seed in
    train mode, at rate 0 in eval mode; the plain version under
    ``plain_ops``. ``return_probs``: ``(context, probabilities)``."""
    if not site.training:
        rate = 0.0
    seed = None
    if rate > 0.0:
        seed = shard_seed(site_seed(site), site.dropout_rank, q.shape[0], num_heads)
    fn = attention_ref if site.plain_ops else attention
    return fn(q, k, v, bias, num_heads=num_heads, dropout_rate=rate, seed=seed,
              return_probs=return_probs)


#: the names the JAX sites ``sow`` their maps under
MAP_ATTRS = ("attention_probs", "attention_probs_v")

#: {(site, attribute): probabilities} while the called model's
#: visualization forward runs (``collect_attention_maps``), else None
_MAP_SINK: contextvars.ContextVar = contextvars.ContextVar("attention_maps", default=None)


def keep_map(site: nn.Module, attr: str, probs: torch.Tensor) -> None:
    """Hand a site's probabilities to the forward that collects them."""
    sink = _MAP_SINK.get()
    if sink is not None:
        sink[(site, attr)] = probs


@contextlib.contextmanager
def collect_attention_maps(model: nn.Module):
    """Collect the maps of a forward of ``model`` under
    ``cfg.visualization``. Yields a dict that, once the block ends, holds
    {module path from ``model`` + "." + attribute: probabilities}, in the
    order of ``named_modules`` (``core.weights.flax_path`` names the flax
    ``intermediates`` path of each). Yields None without
    ``visualization``, and inside another model's collecting forward, whose
    dict gets the maps under its own paths."""
    if not model.cfg.visualization or _MAP_SINK.get() is not None:
        yield None
        return
    sink, maps = {}, {}
    token = _MAP_SINK.set(sink)
    try:
        yield maps
    finally:
        _MAP_SINK.reset(token)
    for name, m in model.named_modules():
        for attr in MAP_ATTRS:
            if (m, attr) in sink:
                maps[f"{name}.{attr}"] = sink[(m, attr)]


def use_plain_ops(model: nn.Module, plain: bool = True) -> nn.Module:
    """Route every attention and LayerNorm of ``model`` through the plain
    PyTorch versions (``plain=True``) or the kernels' entry points.

    The plain versions exist to check the kernels against; the main path
    never sets this."""
    for m in model.modules():
        if hasattr(m, "plain_ops"):
            m.plain_ops = plain
    return model


class SelfAttention(nn.Module):
    """Q/K/V projections + attention core; serves both streams. With
    ``dynamic`` (image stream), Q and K are gated by 1 + sigmoid of a
    projection of the mean-pooled text embedding (reference dynamic
    attention, vilbert.py:577-586)."""

    def __init__(self, cfg: ModelConfig, hidden_size: int, num_heads: int,
                 dropout_rate: float, dynamic: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.dynamic = dynamic
        self.visualization = cfg.visualization
        self.plain_ops = False
        self.dropout_generator: Optional[torch.Generator] = None
        self.dropout_rank = 0  # set_dropout_generator
        self.query = Linear(cfg, hidden_size, hidden_size)
        self.key = Linear(cfg, hidden_size, hidden_size)
        self.value = Linear(cfg, hidden_size, hidden_size)
        if dynamic:
            self.dyLinear_q = Linear(cfg, cfg.hidden_size, hidden_size)
            self.dyLinear_k = Linear(cfg, cfg.hidden_size, hidden_size)

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_bias: torch.Tensor,
        txt_embedding: Optional[torch.Tensor] = None,
        txt_mask2: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        q = self.query(hidden_states)
        k = self.key(hidden_states)
        v = self.value(hidden_states)
        if self.dynamic:
            pooled = (txt_embedding * txt_mask2).sum(1) / txt_mask2.sum(1)
            q = q * (1.0 + torch.sigmoid(self.dyLinear_q(pooled)))[:, None, :]
            k = k * (1.0 + torch.sigmoid(self.dyLinear_k(pooled)))[:, None, :]
        out = attend(self, q, k, v, attention_bias, self.num_heads, self.dropout_rate,
                     self.visualization)
        if self.visualization:
            out, probs = out
            keep_map(self, "attention_probs", probs)
        return out


class AttentionOutput(nn.Module):
    """dense -> dropout -> LN(x + input) (reference BertSelfOutput)."""

    def __init__(self, cfg: ModelConfig, hidden_size: int, dropout_rate: float):
        super().__init__()
        self.dense = Linear(cfg, hidden_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, dtype=param_dtype(cfg))
        self.dropout = Dropout(dropout_rate)

    def forward(self, hidden_states: torch.Tensor, input_tensor: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(hidden_states)), input_tensor)


class Attention(nn.Module):
    """SelfAttention + AttentionOutput (reference BertAttention)."""

    def __init__(self, cfg: ModelConfig, hidden_size: int, num_heads: int,
                 attn_dropout: float, hidden_dropout: float, dynamic: bool = False):
        super().__init__()
        self.self = SelfAttention(cfg, hidden_size, num_heads, attn_dropout, dynamic)
        self.output = AttentionOutput(cfg, hidden_size, hidden_dropout)

    def forward(self, hidden_states, attention_bias, txt_embedding=None, txt_mask2=None):
        ctx = self.self(hidden_states, attention_bias, txt_embedding, txt_mask2)
        return self.output(ctx, hidden_states)


class Intermediate(nn.Module):
    """First half of the JAX FeedForward: dense -> activation."""

    def __init__(self, cfg: ModelConfig, hidden_size: int, intermediate_size: int, act: str):
        super().__init__()
        self.dense = Linear(cfg, hidden_size, intermediate_size)
        self.act = resolve_act(act, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class Output(nn.Module):
    """Second half of the JAX FeedForward: dense -> dropout -> LN(+ residual)."""

    def __init__(self, cfg: ModelConfig, intermediate_size: int, hidden_size: int,
                 dropout_rate: float):
        super().__init__()
        self.dense = Linear(cfg, intermediate_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, dtype=param_dtype(cfg))
        self.dropout = Dropout(dropout_rate)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(h)), residual)


class TextLayer(nn.Module):
    """One text-stream transformer block (reference BertLayer)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = Attention(
            cfg, cfg.hidden_size, cfg.num_attention_heads,
            cfg.attention_probs_dropout_prob, cfg.hidden_dropout_prob,
        )
        self.intermediate = Intermediate(
            cfg, cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act
        )
        self.output = Output(
            cfg, cfg.intermediate_size, cfg.hidden_size, cfg.hidden_dropout_prob
        )

    def forward(self, hidden_states: torch.Tensor, attention_bias: torch.Tensor) -> torch.Tensor:
        attn = self.attention(hidden_states, attention_bias)
        return self.output(self.intermediate(attn), attn)


class ImageLayer(nn.Module):
    """One image-stream block (reference BertImageLayer)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = Attention(
            cfg, cfg.v_hidden_size, cfg.v_num_attention_heads,
            cfg.v_attention_probs_dropout_prob, cfg.v_hidden_dropout_prob,
            dynamic=cfg.dynamic_attention,
        )
        self.intermediate = Intermediate(
            cfg, cfg.v_hidden_size, cfg.v_intermediate_size, cfg.v_hidden_act
        )
        self.output = Output(
            cfg, cfg.v_intermediate_size, cfg.v_hidden_size, cfg.v_hidden_dropout_prob
        )

    def forward(
        self,
        hidden_states: torch.Tensor,
        attention_bias: torch.Tensor,
        txt_embedding: torch.Tensor,
        txt_mask2: torch.Tensor,
    ) -> torch.Tensor:
        attn = self.attention(hidden_states, attention_bias, txt_embedding, txt_mask2)
        return self.output(self.intermediate(attn), attn)
