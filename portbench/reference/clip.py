"""The plain reference text tower: transformers' CLIPTextModel (SD2's
OpenCLIP-ViT/H text transformer) in plain torch, with transformers'
parameter names.

Token plus learned position embeddings; pre-LN layers of causal
multi-head self-attention (scale head_dim^-0.5, biased projections) and an
MLP fc2(gelu(fc1)) with erf-GELU; a final LayerNorm. The output is the last
hidden state after the final LayerNorm (what Stable Diffusion 2 conditions
on).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["CLIPTextModel"]


class _Module(nn.Module):
    """Holds children under transformers' names."""


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        b, s, d = x.shape
        split = lambda t: t.view(b, s, self.heads, d // self.heads
                                 ).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), \
            split(self.v_proj(x))
        scores = q @ k.transpose(-1, -2) * (d // self.heads) ** -0.5
        scores = scores.masked_fill(~mask, float("-inf"))
        o = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class _Layer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.self_attn = _Attention(d, cfg["num_attention_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = _Module()
        self.mlp.fc1 = nn.Linear(d, cfg["intermediate_size"])
        self.mlp.fc2 = nn.Linear(cfg["intermediate_size"], d)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """`forward(input_ids (B, S))` -> last hidden state (B, S, D)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["hidden_act"] != "gelu":
            raise ValueError(f"hidden_act {cfg['hidden_act']!r}")
        d = cfg["hidden_size"]
        tm = self.text_model = _Module()
        tm.embeddings = _Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        tm.embeddings.position_embedding = nn.Embedding(
            cfg["max_position_embeddings"], d)
        tm.encoder = _Module()
        tm.encoder.layers = nn.ModuleList(
            [_Layer(cfg) for _ in range(cfg["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])

    def forward(self, input_ids):
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding.weight[:s][None]
        mask = torch.ones(s, s, dtype=torch.bool,
                          device=input_ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)
