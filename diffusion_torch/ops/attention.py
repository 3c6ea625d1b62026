"""Attention dispatch: plain attention or the flash kernel.

Counterpart of `diffusion_tpu/ops/attention.py` without the sequence- and
tensor-parallel contexts. Every entry point takes (B, S, H, D) q/k/v. The
eligibility rule is the JAX one, with "the backend is a TPU" read as "the
tensor lies on a CUDA device", plus what the CUDA kernels take: bf16 q/k/v
with head dim 64. At 512px the bf16 UNet's S=4096 and S=1024
self-attention run the kernel; cross-attention (77 keys), the S=256 and
S=64 stages, CLIP's masked attention, and every fp32, fp16 or head-dim-128
call stay on plain torch math (a matmul, a softmax and a matmul), which
computes the same function (the JAX kernel runs in any dtype).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from diffusion_torch.ops.flash_attention import flash_attention

__all__ = ["multi_head_attention", "flash_eligible"]


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain (B, S, H, D) attention, the counterpart of JAX's
    `_xla_attention`: fp32 scores, probabilities in q's dtype. `mask`
    broadcasts against (B, H, Sq, Sk); False drops the key."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _shape_eligible(q_shape: Sequence[int], k_shape: Sequence[int]) -> bool:
    # the JAX rule (attention.py `_flash_eligible`): long queries, at least
    # 256 keys, 64-multiple heads, 128-multiple lengths
    return (q_shape[1] >= 1024 and k_shape[1] >= 256
            and q_shape[-1] % 64 == 0
            and q_shape[1] % 128 == 0 and k_shape[1] % 128 == 0)


def flash_eligible(device_type: str, dtype: torch.dtype,
                   q_shape: Sequence[int], k_shape: Sequence[int],
                   masked: bool) -> bool:
    """Whether (B, S, H, D) attention goes to the flash kernel: unmasked,
    on a CUDA device, in bf16 with head dim 64 (the kernels' one case), at
    a shape the JAX rule sends to its kernel."""
    return (not masked and device_type == "cuda" and dtype == torch.bfloat16
            and q_shape[-1] == 64 and _shape_eligible(q_shape, k_shape))


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, S, H, D) tensors."""
    if flash_eligible(q.device.type, q.dtype, q.shape, k.shape,
                      mask is not None):
        return flash_attention(q, k, v)[0]
    return _xla_attention(q, k, v, mask)
