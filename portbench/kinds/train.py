"""Training cells: `Trainer.fit()` of the program over latents drawn from
the seed, a closed loop of steps.

One fit() drives everything, as one object: its first `checked_steps`
steps are set-up (warm-up and the readings the check compares), then the
measured window runs until `--seconds` have passed (a callback lowers
`trainer.max_batches`; the window ends on a synchronization), then, with
`--trace 1`, `trace_steps` more steps run under torch.profiler. The
program's state is then freed and the reference follows the first
`checked_steps` steps from the same weights, batches and draws.
"""

from __future__ import annotations

import gc
import importlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from diffusion_torch.train.events import Callback
from portbench.common import Check, Run
from portbench.reference.train import alphas_cumprod, train_steps
from portbench.reference.unet import UNet2DCondition, unet_spec
from portbench.trace import WINDOW, read_trace
from portbench.weights import derive_seed, draw_like

__all__ = ["run", "Feed", "draws", "program_model", "compare"]

_LATENTS, _CAPTIONS = "image_latents", "caption_latents"


class Feed:
    """Batch k of the run: latents (B, side, side, C) and caption latents
    (B, tokens, width), N(0, 1), drawn on the device from (seed, k). Every
    batch differs; iterating again continues where the last left off."""

    def __init__(self, seed: int, traffic: dict, config: dict, device):
        self.seed, self.device, self.k = seed, device, 0
        side = traffic["latent_side"]
        self.shapes = ((traffic["batch_size"], side, side,
                        config["unet"]["in_channels"]),
                       (traffic["batch_size"], traffic["caption_tokens"],
                        config["unet"]["cross_attention_dim"]))

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=self.device).manual_seed(
            derive_seed(self.seed, "data", k))
        return {name: torch.randn(shape, generator=gen, device=self.device)
                for name, shape in zip((_LATENTS, _CAPTIONS), self.shapes)}

    def __iter__(self):
        while True:
            self.k += 1
            yield self.batch(self.k - 1)


def draws(seed: int, step: int, micro: int, latents: torch.Tensor,
          timesteps: int) -> tuple:
    """(noise, timesteps) of microbatch `micro` of step `step`."""
    gen = torch.Generator(device=latents.device).manual_seed(
        derive_seed(seed, "noise", step, micro))
    t = torch.randint(0, timesteps, (latents.shape[0],), generator=gen,
                      device=latents.device)
    return torch.randn(latents.shape, generator=gen,
                       device=latents.device), t


def program_model(config: dict, device):
    """The program's model from the configuration's model function, made on
    the meta device (so it draws nothing) and then laid out on
    `device`; it raises where the built UNet's widths are not the file's."""
    module, fn = config["model"].rsplit(".", 1)
    make = getattr(importlib.import_module(module), fn)
    model = make(**config.get("model_kwargs", {}), device="meta")
    model.unet.to_empty(device=device)
    built, want = model.unet.config, unet_spec(config["unet"])
    got = {"block_out_channels": list(built.block_out_channels),
           "layers_per_block": built.layers_per_block,
           "attention_head_dim": list(built.attention_head_dim),
           "cross_attention_dim": built.cross_attention_dim,
           "norm_num_groups": built.norm_num_groups,
           "block_has_attention": list(built.block_has_attention),
           "use_linear_projection": built.use_linear_projection}
    diff = {k: (v, want[k]) for k, v in got.items() if v != want[k]}
    if diff:
        raise ValueError(f"the model's UNet is not the config's: {diff}")
    return model


def _recipe_trainer(model, feed, config, traffic, hook, callbacks, device):
    from diffusion_torch.algorithms.ema import EMA
    from diffusion_torch.algorithms.low_precision import (
        LowPrecisionGroupNorm, LowPrecisionLayerNorm)
    from diffusion_torch.train.optim import adamw, multi_step_with_warmup
    from diffusion_torch.train.trainer import Trainer
    recipe = config["train"]
    algorithms = [LowPrecisionGroupNorm(), LowPrecisionLayerNorm()]
    if recipe.get("ema"):
        algorithms.insert(0, EMA(half_life=None, **recipe["ema"]))
    return Trainer(
        model=model, train_dataloader=feed,
        optimizers=adamw(lr=recipe["lr"], betas=tuple(recipe["betas"]),
                         eps=recipe["eps"],
                         weight_decay=recipe["weight_decay"]),
        schedulers=multi_step_with_warmup(
            t_warmup=f"{recipe['warmup_batches']}ba",
            milestones=recipe["milestones"]),
        algorithms=algorithms, callbacks=callbacks,
        max_duration=recipe["max_duration"],
        device_train_microbatch_size=traffic["microbatch"],
        precision=recipe["precision"], seed=17, noise_hook=hook,
        device=device)


class _Window(Callback):
    """The Trainer callback that reads the checked steps, opens the
    window, closes it at the deadline and runs the traced steps."""

    def __init__(self, trainer_ref: List[Any], names: List[str], start,
                 checked: int, seconds: float, trace_steps: int, device):
        self.ref, self.names, self.start = trainer_ref, names, start
        self.checked, self.seconds = checked, seconds
        self.trace_steps, self.device = trace_steps, device
        self.losses: List[torch.Tensor] = []
        self.grad_norms = self.change_norms = None
        self.t0 = self.t_end = self.deadline = None
        self.window_steps = 0
        self.prof = self.range = None
        self.peak = 0
        self.ends: List[float] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch_end(self, state, logger) -> None:
        trainer = self.ref[0]
        b = state.timestamp.batch
        self.losses.append(state.metrics["loss/train/total"])
        ts = trainer.train_state
        if b == 1:
            b1 = ts.optimizer.b1
            self.grad_norms = (torch.stack(torch._foreach_norm(
                [m.float() for m in ts.optimizer.mu])).double()
                / (1.0 - b1)).cpu()
        if b == self.checked:
            with torch.no_grad():
                self.change_norms = torch.stack(
                    [(ts.params[n].detach() - self.start[n]).double().norm()
                     for n in self.names]).cpu()
            self.start = None
            self._sync()
            # the freed snapshot stays in the allocator's cache: emptying
            # it would make the window's first step allocate anew
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
            self.t0 = time.perf_counter()
            self.deadline = self.t0 + self.seconds
            return
        if self.t0 is None:
            return
        if self.t_end is None:
            self.ends.append(time.perf_counter())
        if self.t_end is None and time.perf_counter() >= self.deadline:
            self._sync()
            self.t_end = time.perf_counter()
            self.window_steps = b - self.checked
            if self.device.type == "cuda":
                self.peak = torch.cuda.max_memory_allocated(self.device)
            if self.trace_steps:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
                self.range = torch.profiler.record_function(WINDOW)
                self.range.__enter__()
            trainer.max_batches = b + self.trace_steps
            return
        if self.range is not None and b == trainer.max_batches:
            self._sync()
            self.range.__exit__(None, None, None)
            self.prof.stop()


def _quarters(ends: List[float], t0: float, batch: int) -> None:
    """Samples/s in each quarter of the window by the host's clock at each
    step's end (a diagnostic on standard error: a rate that falls through
    the window says the run is not steady)."""
    if len(ends) < 8:
        return
    span = ends[-1] - t0
    rates = []
    for q in range(4):
        lo, hi = t0 + span * q / 4, t0 + span * (q + 1) / 4
        n = sum(lo < e <= hi for e in ends)
        rates.append(n * batch / (hi - lo))
    print("portbench: samples/s by quarter of the window (host clock at "
          "each step's end): " + ", ".join(f"{r:.2f}" for r in rates),
          file=sys.stderr)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """What the check can compare: each checked step's loss (relative gap,
    worst step); the first gradient's leaf norms at the worst leaf (the gap
    of the norms over the larger of the reference leaf's norm and the
    median leaf's); the parameters' change's leaf norms likewise, leaving
    out leaves whose reference gradient is under a thousandth of the
    median leaf's. All of them, with the worst leaves' names, go to
    standard error."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    order = [prog["names"].index(n) for n in ref["names"]]
    gp = prog["grad_norms"].numpy()[order]
    gr = ref["grad_norms"].numpy()
    cp = prog["change_norms"].numpy()[order]
    cr = ref["change_norms"].numpy()
    grad = np.abs(gp - gr) / np.maximum(gr, np.median(gr))
    moved = gr >= 1e-3 * np.median(gr)
    change = np.abs(cp - cr)[moved] / np.maximum(cr[moved],
                                                 np.median(cr[moved]))
    got = {"loss": float(np.max(np.abs(lp - lr) / np.abs(lr))),
           "first_grad": float(grad.max()), "change": float(change.max())}
    names = np.asarray(ref["names"])
    print(f"portbench: numbers {got}; worst leaves: first_grad "
          f"{names[grad.argmax()]}, change {names[moved][change.argmax()]}; "
          f"{int((~moved).sum())} leaves left out of the change",
          file=sys.stderr)
    return got


def compare(prog: dict, ref: dict, limits: dict) -> List[Check]:
    """The numbers this cell compares: those its limits name."""
    got = numbers(prog, ref)
    return [Check(n, got[n], limits[n]) for n in got if n in limits]


def reference(files: dict, seed: int, device, block_rows: int,
              control: bool = False, keep: float = 1.0) -> dict:
    """The reference over the checked steps, from the seed alone (in fp8
    with `control`; `keep` < 1 plants the half-batch fault)."""
    config, traffic = files["config"], files["traffic"]
    with torch.device("meta"):
        unet = UNet2DCondition(unet_spec(config["unet"]))
    unet.to_empty(device=device)
    flat, views = draw_like(unet, derive_seed(seed, "unet"), device)
    unet.load_state_dict(views)
    del flat, views
    feed = Feed(seed, traffic, config, device)
    n = traffic["checked_steps"]
    batches = [feed.batch(k) for k in range(n)]
    n_micro = traffic["batch_size"] // traffic["microbatch"]
    steps = config["scheduler"]["num_train_timesteps"]
    all_draws = []
    for s, batch in enumerate(batches):
        lat = batch[_LATENTS]
        m = traffic["microbatch"]
        all_draws.append([draws(seed, s, i, lat[i * m:(i + 1) * m], steps)
                          for i in range(n_micro)])
    abar = alphas_cumprod(config["scheduler"])
    if control:
        from portbench.reference.lowp import Fp8Products
        with Fp8Products():
            return train_steps(unet, batches, all_draws, config["train"],
                               abar, block_rows, keep)
    return train_steps(unet, batches, all_draws, config["train"], abar,
                       block_rows, keep)


def run(files: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of a training cell. `plant(model, trainer)` may break the
    program underneath (the tests' faults)."""
    config, traffic = files["config"], files["traffic"]
    checked = traffic["checked_steps"]
    model = program_model(config, device)
    with torch.device("meta"):
        names_from = UNet2DCondition(unet_spec(config["unet"]))
    flat, views = draw_like(names_from, derive_seed(seed, "unet"), device)
    model.unet.load_state_dict(views)
    feed = Feed(seed, traffic, config, device)
    steps = config["scheduler"]["num_train_timesteps"]

    def hook(step, micro, n_accum, mb):
        return draws(seed, step, micro, mb[_LATENTS], steps)

    names = [n for n, p in model.unet.named_parameters() if p.requires_grad]
    holder: List[Any] = []
    window = _Window(holder, names, views, checked, seconds,
                     traffic["trace_steps"] if trace else 0, device)
    del flat, views
    trainer = _recipe_trainer(model, feed, config, traffic, hook, [window],
                              device)
    holder.append(trainer)
    if plant is not None:
        plant(model, trainer)
    trainer.max_batches = 1 << 40
    trainer.fit()
    if window.t_end is None:
        raise RuntimeError("the fit ended before the window closed")
    setup_s = window.t0 - t_start
    losses = torch.stack(window.losses).double().cpu().numpy()
    in_window = losses[checked:checked + window.window_steps]
    prog = {"names": names, "losses": losses[:checked].tolist(),
            "grad_norms": window.grad_norms,
            "change_norms": window.change_norms}
    samples = window.window_steps * traffic["batch_size"]
    win_s = window.t_end - window.t0
    tr = read_trace(window.prof) if window.prof is not None else None
    _quarters(window.ends, window.t0, traffic["batch_size"])
    trainer.close()
    del trainer, model, holder, window.ref, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference(files, seed, device, traffic["reference_rows"])
    checks = compare(prog, ref, files["check"]["limits"])
    return {
        "end_to_end": {"setup_s": setup_s,
                       "train_samples_per_s": samples / win_s},
        "attempted": int(window.window_steps),
        "failed": int(np.sum(~np.isfinite(in_window))),
        "checks": checks,
        "peak_bytes": window.peak,
        "trace": tr,
        "run": Run(cell=files["cell"], config=config, traffic=traffic,
                   window={"steps": window.window_steps, "samples": samples,
                           "seconds": win_s, "peak_bytes": window.peak,
                           "traced_steps": traffic["trace_steps"] if tr
                           else 0},
                   trace=tr),
    }
