"""CLIP transformers: the text tower that conditions the UNet, and the
CLIPScore towers (ViT-L/14 vision and text, with their projections).

Counterparts of `CLIPTextModel`, `CLIPVisionModel` and `CLIPModel` in
`diffusion_tpu/models/clip.py`, with transformers' parameter names
(`text_model.encoder.layers.i.self_attn.q_proj`, `vision_model.embeddings.
class_embedding`, `vision_model.pre_layrnorm` with transformers' own
spelling, `visual_projection`, ...), so a transformers state_dict loads as
it is. Pre-LN transformers: the text tower causal, with the exact erf GELU
(SD2's) or quick GELU (ViT-L/14's, x * sigmoid(1.702 x)); the vision tower
a ViT with a class token, a patch convolution without bias and the
post-LayerNorm on the class token. The text attention is masked and the
towers compute in fp32 (the metric towers always), so their attention runs
on plain torch math.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_torch.models.layers import Conv2d, Container, LayerNorm, Linear
from diffusion_torch.ops.attention import multi_head_attention

__all__ = ["CLIPTextConfig", "CLIPVisionConfig", "CLIPTextModel",
           "CLIPVisionModel", "CLIPModel", "SD2_TEXT_CONFIG",
           "VIT_L14_TEXT_CONFIG", "VIT_L14_VISION_CONFIG"]


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
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Same fields and defaults as the JAX CLIPVisionConfig (ViT-L/14 at
    224px)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768


SD2_TEXT_CONFIG = CLIPTextConfig()
# openai/clip-vit-large-patch14, the CLIPScore towers
VIT_L14_TEXT_CONFIG = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                                     num_hidden_layers=12,
                                     num_attention_heads=12,
                                     hidden_act="quick_gelu",
                                     projection_dim=768)
VIT_L14_VISION_CONFIG = CLIPVisionConfig()


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        # exact erf GELU (transformers' "gelu"), not the tanh approximation
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation {name!r}")


class _CLIPLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.hidden_act = cfg.hidden_act
        self.layer_norm1 = LayerNorm(d, cfg.layer_norm_eps)
        self.self_attn = Container()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, Linear(d, d))
        self.layer_norm2 = LayerNorm(d, cfg.layer_norm_eps)
        self.mlp = Container()
        self.mlp.fc1 = Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = Linear(cfg.intermediate_size, d)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, d = x.shape
        h = self.layer_norm1(x)
        shape = (b, s, self.num_heads, d // self.num_heads)
        q = self.self_attn.q_proj(h).view(shape)
        k = self.self_attn.k_proj(h).view(shape)
        v = self.self_attn.v_proj(h).view(shape)
        o = multi_head_attention(q, k, v, mask=mask)
        x = x + self.self_attn.out_proj(o.reshape(b, s, d))
        h = self.mlp.fc2(_act(self.hidden_act,
                              self.mlp.fc1(self.layer_norm2(x))))
        return x + h


def _encoder(cfg) -> Container:
    encoder = Container()
    encoder.layers = nn.ModuleList(
        [_CLIPLayer(cfg) for _ in range(cfg.num_hidden_layers)])
    return encoder


def _final_norm(norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in fp32, returning fp32 (the towers' outputs are fp32)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps)


def _text_transformer(cfg: CLIPTextConfig) -> Container:
    tm = Container()
    tm.embeddings = Container()
    tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size,
                                                 cfg.hidden_size)
    tm.embeddings.position_embedding = nn.Embedding(
        cfg.max_position_embeddings, cfg.hidden_size)
    # the JAX module draws position embeddings from normal(0.01)
    tm.embeddings.position_embedding.flax_init_std = 0.01
    tm.encoder = _encoder(cfg)
    tm.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
    return tm


def _text_forward(tm: Container, dtype: torch.dtype,
                  input_ids: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s = input_ids.shape
    tok = tm.embeddings.token_embedding(input_ids).to(dtype)
    pos = tm.embeddings.position_embedding.weight[:s].to(dtype)
    x = tok + pos[None]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=input_ids.device).tril()[None, None]
    for layer in tm.encoder.layers:
        x = layer(x, causal)
    x = _final_norm(tm.final_layer_norm, x)
    # pooled = hidden state at the EOT token (the highest id)
    pooled = x[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
    return x, pooled


def _vision_transformer(cfg: CLIPVisionConfig) -> Container:
    vm = Container()
    vm.embeddings = Container()
    vm.embeddings.class_embedding = nn.Parameter(
        torch.zeros(cfg.hidden_size))
    vm.embeddings.patch_embedding = Conv2d(
        3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
        bias=False)
    n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    vm.embeddings.position_embedding = nn.Embedding(n, cfg.hidden_size)
    # the JAX module draws both from normal(0.02)
    vm.embeddings.position_embedding.flax_init_std = 0.02
    vm.embeddings.flax_normal_params = {"class_embedding": 0.02}
    vm.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
    vm.encoder = _encoder(cfg)
    vm.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
    return vm


def _vision_forward(vm: Container, dtype: torch.dtype,
                    pixel_values: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    emb = vm.embeddings
    b = pixel_values.shape[0]
    # NHWC memory viewed as NCHW; patches in row-major order, as flax's
    # reshape of its NHWC conv output
    patches = emb.patch_embedding(pixel_values.to(dtype).permute(0, 3, 1, 2))
    patches = patches.flatten(2).transpose(1, 2)
    cls = emb.class_embedding.to(dtype).expand(b, 1, -1)
    x = torch.cat([cls, patches], dim=1)
    x = x + emb.position_embedding.weight[None].to(dtype)
    x = vm.pre_layrnorm(x)
    for layer in vm.encoder.layers:
        x = layer(x, None)
    pooled = _final_norm(vm.post_layernorm, x[:, 0])
    return x.float(), pooled


class CLIPTextModel(nn.Module):
    """Causal text transformer: ids (B, S) -> (last_hidden_state fp32
    (B, S, D), pooled fp32 (B, D) at the EOT token)."""

    def __init__(self, config: CLIPTextConfig = SD2_TEXT_CONFIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.text_model = _text_transformer(config)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _text_forward(self.text_model, self.dtype, input_ids)


class CLIPVisionModel(nn.Module):
    """ViT with a class token: CLIP-normalized images (B, H, W, 3) ->
    (last_hidden_state fp32 (B, 1 + patches, D), pooled fp32 (B, D), the
    post-LayerNormed class token)."""

    def __init__(self, config: CLIPVisionConfig = VIT_L14_VISION_CONFIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.vision_model = _vision_transformer(config)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _vision_forward(self.vision_model, self.dtype, pixel_values)


class CLIPModel(nn.Module):
    """Both towers and their projections (no bias): the CLIPScore model.
    `forward(ids, images)` -> (text features, image features), fp32."""

    def __init__(self, text_config: CLIPTextConfig = VIT_L14_TEXT_CONFIG,
                 vision_config: CLIPVisionConfig = VIT_L14_VISION_CONFIG,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.text_config, self.vision_config = text_config, vision_config
        self.dtype = dtype
        self.text_model = _text_transformer(text_config)
        self.vision_model = _vision_transformer(vision_config)
        self.text_projection = Linear(text_config.hidden_size,
                                      text_config.projection_dim, bias=False)
        self.visual_projection = Linear(vision_config.hidden_size,
                                        vision_config.projection_dim,
                                        bias=False)

    def get_text_features(self, input_ids: torch.Tensor) -> torch.Tensor:
        _, pooled = _text_forward(self.text_model, self.dtype, input_ids)
        return self.text_projection(pooled)

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        _, pooled = _vision_forward(self.vision_model, self.dtype,
                                    pixel_values)
        return self.visual_projection(pooled)

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.get_text_features(input_ids),
                self.get_image_features(pixel_values))
