"""The reference's training steps: the epsilon-prediction loss over DDPM
noise, its gradient, and AdamW as optax computes it, in float32.

Rows are taken in blocks (`block_rows`) so that plain attention at 4,096
tokens fits beside the model; a block's loss is weighted by its share of
the step's rows, so the summed gradient is the whole step's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["alphas_cumprod", "step_loss", "AdamW", "train_steps"]


def alphas_cumprod(scheduler: dict) -> np.ndarray:
    """DDPM's alpha-bar table (float64) from the config's scheduler."""
    n = scheduler["num_train_timesteps"]
    lo, hi = scheduler["beta_start"], scheduler["beta_end"]
    if scheduler["beta_schedule"] == "scaled_linear":
        betas = np.linspace(lo ** 0.5, hi ** 0.5, n, dtype=np.float64) ** 2
    elif scheduler["beta_schedule"] == "linear":
        betas = np.linspace(lo, hi, n, dtype=np.float64)
    else:
        raise ValueError(f"beta schedule {scheduler['beta_schedule']!r}")
    return np.cumprod(1.0 - betas)


def step_loss(unet, latents, captions, noise, timesteps, abar: torch.Tensor,
              weight: float = 1.0) -> torch.Tensor:
    """weight x mean((unet(noised) - noise)^2) for NHWC latents and noise;
    noised = sqrt(abar_t) x + sqrt(1 - abar_t) eps."""
    a = abar[timesteps].view(-1, 1, 1, 1)
    noised = a.sqrt() * latents + (1.0 - a).sqrt() * noise
    pred = unet(noised.permute(0, 3, 1, 2), timesteps, captions)
    return torch.square(pred.permute(0, 2, 3, 1) - noise).mean() * weight


class AdamW:
    """optax's adamw: mu and nu, bias corrections 1 - b^count, the update
    mu_hat / (sqrt(nu_hat) + eps) + wd p, scaled by the learning rate at the
    update count (which starts at 0)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: Callable[[int], float],
                 b1: float, b2: float, eps: float, weight_decay: float):
        self.params, self.lr = list(params), lr
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        lr = float(self.lr(self.count))
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            update = (mu / c1) / ((nu / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(lr * update)


def leaf_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.double().norm() for t in tensors]).cpu()


def train_steps(unet, batches: List[Dict[str, torch.Tensor]],
                draws: List[List[tuple]], recipe: dict, abar: np.ndarray,
                block_rows: int, keep: float = 1.0) -> dict:
    """Run len(batches) steps from the module's present weights. `draws[s]`
    holds (noise, timesteps) per microbatch of step s, as the program was
    handed them. Returns each step's loss, the leaf norms of the first
    step's gradient, and those of the parameters' change over all steps.
    `keep` < 1 is a planted fault: each microbatch's first `keep` share of
    rows alone, the mean taken over them."""
    names = [n for n, _ in unet.named_parameters()]
    params = [p for _, p in unet.named_parameters()]
    start = [p.detach().clone() for p in params]
    warm = int(recipe["warmup_batches"])
    base = float(recipe["lr"])
    opt = AdamW(params, lambda c: base * min(c / warm, 1.0) if warm else base,
                recipe["betas"][0], recipe["betas"][1], recipe["eps"],
                recipe["weight_decay"])
    abar_t = torch.as_tensor(abar, dtype=torch.float32,
                             device=params[0].device)
    losses, first = [], None
    for batch, step_draws in zip(batches, draws):
        rows = batch["image_latents"].shape[0]
        micro = rows // len(step_draws)
        noise = torch.cat([d[0] for d in step_draws])
        steps_t = torch.cat([d[1] for d in step_draws])
        for p in params:
            p.grad = None
        total = 0.0
        used = max(1, int(micro * keep))
        blocks = [(m0 + lo, min(m0 + lo + block_rows, m0 + used))
                  for m0 in range(0, rows, micro)
                  for lo in range(0, used, block_rows)]
        for lo, hi in blocks:
            loss = step_loss(unet, batch["image_latents"][lo:hi],
                             batch["caption_latents"][lo:hi], noise[lo:hi],
                             steps_t[lo:hi], abar_t,
                             (hi - lo) / (used * (rows // micro)))
            loss.backward()
            total += float(loss.detach())
        grads = [p.grad for p in params]
        if first is None:
            first = leaf_norms(grads)
        opt.step(grads)
        losses.append(total)
    with torch.no_grad():
        change = leaf_norms([p - s for p, s in zip(params, start)])
    return {"names": names, "losses": losses, "grad_norms": first,
            "change_norms": change}
