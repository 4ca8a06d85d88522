"""Co-attentional transformer block (Co-TRM).

Counterpart of ``vilbert_tpu/models/coattention.py`` (reference
BertBiAttention, BertBiOutput, BertConnectionLayer). Stream 1 is vision,
stream 2 text: text queries attend image keys/values (the text-side
context), image queries attend text keys/values (the image-side context).

Quirks kept: the two directions use swapped attention-dropout rates (the
text-side context uses ``v_attention_probs_dropout_prob``), each direction
with its own seed; the reference's dead
``biOutput.q_dense{1,2}`` weights are not created (the importer skips
them); the co-attention mask never reaches the scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vilbert_tpu_torch.core.config import ModelConfig
from vilbert_tpu_torch.models.layers import (
    Dropout,
    Intermediate,
    LayerNorm,
    Linear,
    Output,
    attend,
    keep_map,
    param_dtype,
)


class BiAttention(nn.Module):
    """The two cross-attention directions, one projection set per stream."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        bi = cfg.bi_hidden_size
        self.num_heads = cfg.bi_num_attention_heads
        self.rate_t = cfg.v_attention_probs_dropout_prob  # text queries -> image keys
        self.rate_v = cfg.attention_probs_dropout_prob    # image queries -> text keys
        # maps under visualization: text queries over image keys
        # (attention_probs), image queries over text keys (attention_probs_v)
        self.visualization = cfg.visualization
        self.plain_ops = False
        self.dropout_generator: Optional[torch.Generator] = None
        self.dropout_rank = 0  # set_dropout_generator
        self.query1 = Linear(cfg, cfg.v_hidden_size, bi)
        self.key1 = Linear(cfg, cfg.v_hidden_size, bi)
        self.value1 = Linear(cfg, cfg.v_hidden_size, bi)
        self.query2 = Linear(cfg, cfg.hidden_size, bi)
        self.key2 = Linear(cfg, cfg.hidden_size, bi)
        self.value2 = Linear(cfg, cfg.hidden_size, bi)

    def forward(
        self,
        input_v: torch.Tensor,  # [B, R, v_hidden]
        bias_v: torch.Tensor,   # [B, 1, 1, R]
        input_t: torch.Tensor,  # [B, T, hidden]
        bias_t: torch.Tensor,   # [B, 1, 1, T]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        context_t = attend(
            self, self.query2(input_t), self.key1(input_v), self.value1(input_v), bias_v,
            self.num_heads, self.rate_t, self.visualization,
        )
        context_v = attend(
            self, self.query1(input_v), self.key2(input_t), self.value2(input_t), bias_t,
            self.num_heads, self.rate_v, self.visualization,
        )
        if self.visualization:
            (context_t, probs_t), (context_v, probs_v) = context_t, context_v
            keep_map(self, "attention_probs", probs_t)
            keep_map(self, "attention_probs_v", probs_v)
        return context_v, context_t


class BiOutput(nn.Module):
    """Project each context to its stream width, dropout + residual + LN."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        bi = cfg.bi_hidden_size
        self.dense1 = Linear(cfg, bi, cfg.v_hidden_size)
        self.LayerNorm1 = LayerNorm(cfg.v_hidden_size, dtype=param_dtype(cfg))
        self.dropout1 = Dropout(cfg.v_hidden_dropout_prob)
        self.dense2 = Linear(cfg, bi, cfg.hidden_size)
        self.LayerNorm2 = LayerNorm(cfg.hidden_size, dtype=param_dtype(cfg))
        self.dropout2 = Dropout(cfg.hidden_dropout_prob)

    def forward(self, context_v, input_v, context_t, input_t):
        out_v = self.LayerNorm1(self.dropout1(self.dense1(context_v)), input_v)
        out_t = self.LayerNorm2(self.dropout2(self.dense2(context_t)), input_t)
        return out_v, out_t


class ConnectionLayer(nn.Module):
    """BiAttention + BiOutput + one FFN per stream (reference
    BertConnectionLayer; the FFNs reuse intermediate_size and
    v_intermediate_size, bi_intermediate_size is unused as in the reference)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.biattention = BiAttention(cfg)
        self.biOutput = BiOutput(cfg)
        self.v_intermediate = Intermediate(
            cfg, cfg.v_hidden_size, cfg.v_intermediate_size, cfg.v_hidden_act
        )
        self.v_output = Output(
            cfg, cfg.v_intermediate_size, cfg.v_hidden_size, cfg.v_hidden_dropout_prob
        )
        self.t_intermediate = Intermediate(
            cfg, cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act
        )
        self.t_output = Output(
            cfg, cfg.intermediate_size, cfg.hidden_size, cfg.hidden_dropout_prob
        )

    def forward(self, input_v, bias_v, input_t, bias_t):
        context_v, context_t = self.biattention(input_v, bias_v, input_t, bias_t)
        attn_v, attn_t = self.biOutput(context_v, input_v, context_t, input_t)
        out_v = self.v_output(self.v_intermediate(attn_v), attn_v)
        out_t = self.t_output(self.t_intermediate(attn_t), attn_t)
        return out_v, out_t
