"""Helpers for the port's multi-process tests (this module holds no test
of its own): spawn gloo ranks on the CPU and run a case on each. No JAX
here: the spawned ranks import this module, torch and the port alone.

`spawn(fn, world, tmp, *args, timeout=)` starts `world` processes (spawn
start method), each joining a gloo process group through a FileStore under
`tmp` (no ports: pytest-xdist workers would collide), with one thread;
`fn(rank, world, tmp, *args)` returns a picklable result per rank, saved
with torch.save and returned to the caller in rank order. A rank that fails
or a run past `timeout` seconds raises in the caller.
"""

from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.multiprocessing as mp

from diffusion_torch.train.events import Callback

__all__ = ["spawn"]


def _entry(rank, fn, world, tmp, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.pop("DIFFUSION_TPU_PALLAS_INTERPRET", None)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank)
    try:
        out = fn(rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args, timeout: float = 240.0):
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args),
                             nprocs=world, join=False, start_method="spawn")
    try:
        import time
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
    except mp.ProcessRaisedException as e:
        errors = [open(os.path.join(tmp, f)).read()
                  for f in sorted(os.listdir(tmp)) if f.startswith("error_")]
        raise RuntimeError("\n".join(errors) or str(e)) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------- the ops


def ops_case(rank, world, tmp, inputs):
    """Ring attention, the halo convolution and sp GroupNorm on the full
    group of `world` ranks, on groups of 2 and on one-rank groups: each
    rank's outputs and gradients of its shard; then the tensor-parallel
    ops and layers (`_tp_ops`)."""
    import torch.distributed as dist

    from diffusion_torch.models.layers import Conv2d
    from diffusion_torch.ops.groupnorm import group_norm
    from diffusion_torch.ops.ring_attention import ring_attention
    from diffusion_torch.parallel.sharding import (RowShard, register_group,
                                                   take_rows)
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])] \
        if world == 4 else [dist.group.WORLD]
    # every rank takes part in creating each group
    singles = [dist.new_group([r]) for r in range(world)]
    shards = {world: RowShard(register_group(dist.group.WORLD), rank, world),
              2: RowShard(register_group(pairs[rank // 2]), rank % 2, 2),
              1: RowShard(register_group(singles[rank]), 0, 1)}
    out = {}
    for n, shard in shards.items():
        # ring attention: q/k/v (B, S, H, D) split along S
        q, k, v, do = (take_rows(inputs["attn"][i], shard, dim=1)
                       .clone().requires_grad_(i < 3) for i in range(4))
        o = ring_attention(q, k, v, shard)
        o.backward(do.detach())
        out[("ring", n)] = (o.detach(), q.grad, k.grad, v.grad)
        # 3x3 convolutions, stride 1 and 2, rows split
        for stride in (1, 2):
            conv = Conv2d(8, 8, 3, stride=stride, padding=1)
            conv.load_state_dict(inputs["conv"])
            x = take_rows(inputs["x"], shard).clone().requires_grad_(True)
            y = conv(x, shard)
            y.backward(take_rows(inputs["dy" + str(stride)], shard))
            out[("conv", n, stride)] = (y.detach(), x.grad,
                                        conv.weight.grad, conv.bias.grad)
        # GroupNorm(+SiLU) over channels-last (B, L, C) row shards
        for name in ("gn", "gn_mean"):
            for act in (None, "silu"):
                x = take_rows(inputs[name], shard, dim=1).clone() \
                    .requires_grad_(True)
                scale = inputs["scale"].clone().requires_grad_(True)
                bias = inputs["bias"].clone().requires_grad_(True)
                y = group_norm(x, scale, bias, 4, 1e-5, act, shard)
                y.backward(take_rows(inputs["gy"], shard, dim=1))
                out[(name, n, act)] = (y.detach(), x.grad, scale.grad,
                                       bias.grad)
    out.update(_tp_ops(rank, world, inputs))
    return out


def tp_layers(inputs=None):
    """The tensor-parallel ops test's layers, whole (with `inputs`'
    weights): self- and cross-attention with LoRA (4 heads of 8) and the
    GEGLU."""
    from diffusion_torch.models.layers import Attention, FeedForwardGEGLU
    layers = {"attn": Attention(32, 4, 8, lora_rank=2),
              "xattn": Attention(32, 4, 8, cross_dim=16, lora_rank=2),
              "ff": FeedForwardGEGLU(32)}
    for name, layer in layers.items():
        if inputs is not None:
            layer.load_state_dict(inputs["tp_" + name])
    return layers


def _tp_ops(rank, world, inputs):
    """tp_copy, tp_reduce and the sliced layers over tp groups of 2 (a
    (data 2, tp 2) mesh) and of 4: each rank's outputs and gradients."""
    from diffusion_torch.ops.attention import tensor_parallel
    from diffusion_torch.parallel.mesh import create_mesh
    from diffusion_torch.parallel.sharding import (shard_tensor_parallel,
                                                   tp_copy, tp_reduce)
    out = {}
    for n in (2, 4):
        mesh = create_mesh(fsdp=1, data=world // n, tp=n)
        with tensor_parallel(mesh) as tp:
            # f: the same x on every rank, each rank's own cotangent
            x = inputs["tp_x"].clone().requires_grad_(True)
            y = tp_copy(x, tp)
            y.backward(inputs["tp_g"][rank])
            out[("tp_copy", n)] = (y.detach(), x.grad)
            # g: each rank's own partial, one cotangent
            x = inputs["tp_g"][rank].clone().requires_grad_(True)
            y = tp_reduce(x, tp)
            y.backward(inputs["tp_x"])
            out[("tp_reduce", n)] = (y.detach(), x.grad)
            for name, layer in tp_layers(inputs).items():
                shard_tensor_parallel(layer, tp.index, n, 8)
                h = inputs["tp_h"].clone().requires_grad_(True)
                args = (inputs["tp_ctx"],) if name == "xattn" else ()
                y = layer(h, *args)
                y.backward(inputs["tp_dy"])
                out[(name, n)] = (y.detach(), h.grad, {
                    k: p.grad for k, p in layer.named_parameters()})
    return out


# ------------------------------------------------------------ the trainer


def local_batches(batches, n_accum, rank, world):
    """Rank `rank`'s part of each global batch: its block of every
    microbatch, in microbatch order (the Trainer's layout)."""
    out = []
    for batch in batches:
        parts = {k: [] for k in batch}
        for k, v in batch.items():
            micro = v.shape[0] // n_accum
            m = micro // world
            for i in range(n_accum):
                parts[k].append(v[i * micro + rank * m:
                                  i * micro + (rank + 1) * m])
        out.append({k: torch.cat(v) for k, v in parts.items()})
    return out


def full_state(trainer):
    """The trainer's whole state (gathered where it is sharded)."""
    ts = trainer._full_state() if trainer.train_state.shards \
        else trainer.train_state
    return {"params": {n: p.detach().clone() for n, p in ts.params.items()},
            "ema": {n: e.clone() for n, e in ts.ema_params.items()},
            "mu": [m.clone() for m in ts.optimizer.mu],
            "nu": [v.clone() for v in ts.optimizer.nu],
            "count": ts.optimizer.count, "step": ts.step}


def make_trainer(batches, initial, micro, mesh=None, draws=None, **kw):
    """The tiny model's Trainer of the mesh tests: AdamW (lr 1e-3, wd
    0.01), EMA 0.9 from batch 0, `draws[step][micro]` handed over."""
    from diffusion_torch.algorithms.ema import EMA
    from diffusion_torch.models.models import stable_diffusion_tiny
    from diffusion_torch.train import optim
    from diffusion_torch.train.trainer import Trainer

    class Record(Callback):
        def __init__(self):
            self.steps = []

        def batch_end(self, state, logger):
            self.steps.append({k: float(v) for k, v in state.metrics.items()})

    model = stable_diffusion_tiny(device="cpu", precomputed_latents=True)
    model.unet.load_state_dict(initial)
    hook = None
    if draws is not None:
        def hook(step, i, n_accum, mb):
            return tuple(torch.as_tensor(d) for d in draws[step][i])
    rec = Record()
    trainer = Trainer(model=model, train_dataloader=batches,
                      optimizers=optim.adamw(lr=LR, weight_decay=0.01),
                      algorithms=[EMA(smoothing=0.9, ema_start="0ba")],
                      callbacks=[rec], device_train_microbatch_size=micro,
                      seed=7, device="cpu", mesh=mesh, noise_hook=hook, **kw)
    _record_updates(trainer, rec)
    return trainer, rec


LR = 1e-3


def tp_replicas_differ(trainer):
    """The whole tensors of this tp rank's train state (parameters, AdamW
    moments, EMA; FSDP's local shards under FSDP) whose bits differ from
    another rank's of its tp group (`chip_smoke.py::tp_replicas_differ`,
    a collective over the group), or None without tp."""
    if trainer._tp_shard is None:
        return None
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from chip_smoke import (tp_replicas_differ as differ, tp_sliced_names,
                            train_state_checksums)
    from diffusion_torch.parallel.sharding import process_group
    return differ(*train_state_checksums(trainer.train_state),
                  tp_sliced_names(trainer._tp_dims),
                  process_group(trainer._tp_shard.group))


def _whole(trainer, tensors):
    """Whole tensors from this rank's shards (a collective on a mesh)."""
    if not trainer.train_state.shards:
        return [t.clone() for t in tensors]
    # full_tensor() returns the local tensor itself on one shard: copy
    return [t.clone() for t in trainer._whole(tensors)]


def _record_updates(trainer, rec):
    """Record the gradients each optimizer step takes (before clipping)
    and the second moment after it, whole."""
    opt = trainer.train_state.optimizer
    step = opt.step
    names = list(trainer.train_state.params)
    rec.grads, rec.nu = [], []

    def recording_step(grad_norm=None, grads=None, **ema):
        rec.grads.append(dict(zip(names, _whole(trainer, grads))))
        step(grad_norm=grad_norm, grads=grads, **ema)
        rec.nu.append(dict(zip(names, _whole(trainer, opt.nu))))
    opt.step = recording_step


def adam_bound(got_grads, want_grads, nus, lr=LR, b1=0.9, b2=0.999,
               eps=1e-8, slack=0.0):
    """Per step, per parameter: the elementwise bound on how far two AdamW
    runs' parameters may differ whose gradients differ as given
    (test_torch_lora.py's `test_adapter_steps_match_jax` derives it):
    lr * sum over steps of (D (1 + c_k) / (sqrt(v^) + eps) + c_k (2^-20 +
    rho1 + rho2 / 2)), D the largest gradient difference so far (plus
    `slack` times the tensor's largest gradient, where the reference's
    own step summed its gradient in another order than the gradient it is
    compared by), v^ from `nus`; 4 ulp of the parameters come on top at
    the comparison."""
    import numpy as np
    worst, bound, out = {}, {}, []
    for k, (g, w, nu) in enumerate(zip(got_grads, want_grads, nus), 1):
        a = [(1 - b1) * b1 ** (k - j) / (1 - b1 ** k) for j in range(1, k + 1)]
        b = [(1 - b2) * b2 ** (k - j) / (1 - b2 ** k) for j in range(1, k + 1)]
        c_k = sum(x * x / y for x, y in zip(a, b)) ** 0.5
        rho1, rho2 = (2 * float(np.spacing(np.float32(d) ** k))
                      / (1 - d ** k) for d in (b1, b2))
        for name in w:
            d = (g[name] - w[name]).abs().double() + slack * float(
                w[name].abs().max())
            worst[name] = d if name not in worst else torch.maximum(
                worst[name], d)
            s = torch.sqrt(nu[name].double() / (1 - b2 ** k))
            bound[name] = bound.get(name, 0) + lr * (
                worst[name] * (1 + c_k) / (s + eps)
                + c_k * (2.0 ** -20 + rho1 + rho2 / 2))
        out.append(dict(bound))
    return out


class _Preempt(Callback):
    """As a SIGTERM would, on this rank alone: the trainer's preemption flag
    set after batch `at`."""

    def __init__(self, trainer, at: int):
        self.trainer, self.at = trainer, at

    def batch_end(self, state, logger) -> None:
        if state.timestamp.batch == self.at:
            self.trainer._preempt_requested = True


def trainer_case(rank, world, tmp, runs):
    """Each run: (name, mesh_config, batches (global), n_accum, initial
    weights, micro, draws, trainer keywords, load_path): the fitted
    trainer's whole state, per-step metrics, the whole tensors its tp
    group does not hold bit-equal (`tp_replicas_differ`) and, with an
    `eval_dataloader` keyword (global batches: each rank takes its block),
    an eval's results; a `preempt_at` keyword raises rank 0's preemption
    flag after that batch (or, with load_path, the state a fresh trainer
    restores from it)."""
    from diffusion_torch.parallel.mesh import create_mesh, example_layout
    out = {}
    for name, cfg, batches, n_accum, initial, micro, draws, kw, load in runs:
        mesh = create_mesh(**cfg)
        b_rank, b_world = example_layout(mesh)
        mine = local_batches(batches, n_accum, b_rank, b_world)
        kw = dict(kw)
        if "eval_dataloader" in kw:    # this rank's block of each batch
            kw["eval_dataloader"] = local_batches(kw["eval_dataloader"], 1,
                                                  b_rank, b_world)
        preempt = kw.pop("preempt_at", None)
        if load is not None:
            trainer, _ = make_trainer(mine, initial, micro, mesh,
                                      load_path=load, max_duration="1ba",
                                      **kw)
            out[name] = {"state": full_state(trainer)}
        else:
            trainer, rec = make_trainer(mine, initial, micro, mesh, draws,
                                        max_duration=f"{len(batches)}ba",
                                        **kw)
            if preempt is not None and rank == 0:
                trainer.engine.callbacks.append(_Preempt(trainer, preempt))
            trainer.fit()
            out[name] = {"tp_replicas_differ": tp_replicas_differ(trainer),
                         "state": full_state(trainer), "metrics": rec.steps,
                         "grads": rec.grads, "nu": rec.nu,
                         "eval": trainer.eval() if trainer.evaluators
                         else None,
                         "batch": trainer.state.timestamp.batch}
        trainer.close()
    return out


def yaml_case(name, overrides):
    """Compose yamls/`name` with `overrides` and train it through
    `diffusion_torch.run.main`: the last step's metrics, the mesh's shape,
    the ring's calls, the head counts attention ran with, the layers
    holding tp slices and `tp_replicas_differ`."""
    import diffusion_torch.models.layers as layers
    import diffusion_torch.ops.ring_attention as ring_mod
    import diffusion_torch.train.train as train_mod
    from diffusion_torch import run
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    calls, heads, trainers = [], set(), []
    real_ring, real_mha = ring_mod.ring_attention, layers.multi_head_attention
    real_train = train_mod.train

    def counted(q, k, v, shard):
        calls.append(tuple(q.shape))
        return real_ring(q, k, v, shard)

    def seen(q, k, v, *args, **kwargs):
        heads.add(q.shape[2])
        return real_mha(q, k, v, *args, **kwargs)

    ring_mod.ring_attention, layers.multi_head_attention = counted, seen
    train_mod.train = lambda config: trainers.append(
        real_train(config)) or trainers[-1]
    try:
        run.main(["--config-path", os.path.join(root, "yamls"),
                  "--config-name", name, *overrides])
    finally:
        ring_mod.ring_attention, layers.multi_head_attention = (real_ring,
                                                                real_mha)
        train_mod.train = real_train
    trainer = trainers[-1]
    mesh = trainer.mesh
    tp_layers = {}
    for m in trainer.model.unet.modules():
        if getattr(m, "tp", 1) > 1:
            kind = type(m).__name__
            tp_layers[kind] = tp_layers.get(kind, 0) + 1
    return {"tp_replicas_differ": tp_replicas_differ(trainer),
            "metrics": {k: float(v) for k, v in trainer.state.metrics.items()},
            "batch": trainer.state.timestamp.batch,
            "mesh": [mesh.size(d) for d in range(mesh.ndim)],
            "ring_calls": calls, "attn_heads": heads,
            "tp_layers": tp_layers, "remat": trainer.model.unet.remat,
            "shards": trainer.train_state.shards}


def mesh_case(rank, world, tmp, runs, yamls=()):
    """`trainer_case`'s runs, then each (key, yaml name, overrides) of
    `yamls` through `yaml_case`."""
    out = trainer_case(rank, world, tmp, runs)
    for key, name, overrides in yamls:
        out[key] = yaml_case(name, overrides)
    return out
