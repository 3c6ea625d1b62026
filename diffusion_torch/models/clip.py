"""CLIP text transformer (the conditioning tower).

Counterpart of `CLIPTextModel` in `diffusion_tpu/models/clip.py`, with
transformers' parameter names (`text_model.encoder.layers.i.self_attn.q_proj`,
...). Pre-LN causal transformer with the exact erf GELU of SD2's text tower
(the quick-GELU ViT-L/14 tower is not ported). Attention is masked, so it
runs on plain torch math.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.models.layers import Container, LayerNorm, Linear
from diffusion_torch.ops.attention import multi_head_attention

__all__ = ["CLIPTextConfig", "CLIPTextModel", "SD2_TEXT_CONFIG"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Same fields and defaults as the JAX CLIPTextConfig (SD2's
    OpenCLIP-ViT/H text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 23
    num_attention_heads: int = 16
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


SD2_TEXT_CONFIG = CLIPTextConfig()


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.self_attn = Container()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Linear(d, d))
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = Container()
        self.mlp.fc1 = Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.layer_norm1(x)
        shape = (b, s, self.num_heads, d // self.num_heads)
        q = self.self_attn.q_proj(h).view(shape)
        k = self.self_attn.k_proj(h).view(shape)
        v = self.self_attn.v_proj(h).view(shape)
        o = multi_head_attention(q, k, v, mask=mask)
        x = x + self.self_attn.out_proj(o.reshape(b, s, d))
        # exact erf GELU (transformers' "gelu"), not the tanh approximation
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.layer_norm2(x))))
        return x + h


class CLIPTextModel(nn.Module):
    """Causal text transformer: ids (B, S) -> (last_hidden_state fp32
    (B, S, D), pooled fp32 (B, D) at the EOT token)."""

    def __init__(self, config: CLIPTextConfig = SD2_TEXT_CONFIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        tm = self.text_model = Container()
        tm.embeddings = Container()
        tm.embeddings.token_embedding = nn.Embedding(config.vocab_size,
                                                     config.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)
        # the JAX module draws position embeddings from normal(0.01)
        tm.embeddings.position_embedding.flax_init_std = 0.01
        tm.encoder = Container()
        tm.encoder.layers = nn.ModuleList(
            [_CLIPLayer(config) for _ in range(config.num_hidden_layers)])
        tm.final_layer_norm = LayerNorm(config.hidden_size,
                                        config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tm = self.text_model
        b, s = input_ids.shape
        tok = tm.embeddings.token_embedding(input_ids).to(self.dtype)
        pos = tm.embeddings.position_embedding.weight[:s].to(self.dtype)
        x = tok + pos[None]
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = F.layer_norm(x.float(), tm.final_layer_norm.normalized_shape,
                         tm.final_layer_norm.weight, tm.final_layer_norm.bias,
                         tm.final_layer_norm.eps)
        # pooled = hidden state at the EOT token (the highest id)
        pooled = x[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
        return x, pooled
