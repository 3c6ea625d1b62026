"""Flash-attention forward: the Hopper kernel and its plain PyTorch version.

Counterpart of `diffusion_tpu/ops/flash_attention.py` (forward only; the
backward kernels come with the training slice). Both functions take
`(B, S, H, D)` q/k/v, as the JAX entry points do, and return `(out, lse)`:
out `(B, Sq, H, D)` in q's dtype and lse `(B, H, Sq)` fp32, the logsumexp of
the scaled scores, as `flash_attention_with_lse` returns them.

On a CUDA tensor `flash_attention` launches the kernel
(`diffusion_torch/csrc/flash_attention.cu`: bf16, head dim 64, sequence
lengths a multiple of 64) or raises; on a CPU tensor it runs
`flash_attention_reference`, which mirrors JAX's `_xla_attention_with_lse`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from diffusion_torch.ops._build import LaunchCounter, library

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_cuda", "launches"]

launches = LaunchCounter()

_HEAD_DIM = 64
_TILE = 64


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the logsumexp: fp32 scores, probabilities cast
    to q's dtype before the product with v."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (B, S, H, 64) bf16 views with unit last stride."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash kernel takes bf16, {name} is {t.dtype}")
        if t.ndim != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"flash kernel takes (B, S, H, {_HEAD_DIM}), "
                             f"{name} is {tuple(t.shape)}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} needs a unit last stride, strides that "
                             f"are multiples of 8 and 16-byte alignment")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h:
        raise ValueError(f"k/v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if sq % _TILE or skv % _TILE:
        raise ValueError(f"flash kernel needs sequence lengths that are "
                         f"multiples of {_TILE}, got {sq} and {skv}")
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().dt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, skv, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], d ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"CUDA error {rc}")
    launches.add()
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(d)) v over (B, S, H, D) and its logsumexp."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return flash_attention_reference(q, k, v)
