"""Composition layer: config dict -> model/optimizer/data/trainer -> fit.

Counterpart of `diffusion_tpu/train/train.py`, line by line (the
reference's train composer, diffusion/train.py:21-138): seeds numpy's RNG
(:29), instantiates the model (:31), optimizer (:33), train dataloader with
the per-process batch division (:38-42), evaluators (:48-63), loggers with
wandb handling (:70-84), algorithms (:86-108), callbacks (:110-114), LR
scheduler (:116), Trainer (:118-128), then eval-first + fit (:130-138).

The yamls' `_target_`s name `diffusion_tpu.*`; the port's config loader
resolves them under `diffusion_torch.`. Launched on several processes
(`torchrun`), it joins the process group first (`parallel/dist.py`) and,
where the yaml has `trainer.mesh_config`, builds the process mesh before
the readers, so the batch divides over the ranks that read different
examples (dcn x fsdp x data; an sp group shares its examples) and the
readers split them so (`utils/device.py::rank_and_world`). The yaml's
`compile_cache_dir` (or $DIFFUSION_TORCH_COMPILE_CACHE) is where the kernel
library is built and found (`utils/compile_cache.py`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from diffusion_torch.config import instantiate, select
from diffusion_torch.config.loader import _import_target
from diffusion_torch.parallel import dist
from diffusion_torch.parallel.mesh import create_mesh
from diffusion_torch.train import optim as optim_mod
from diffusion_torch.train.optim import adamw, constant_scheduler
from diffusion_torch.train.trainer import Evaluator, Trainer
from diffusion_torch.utils.compile_cache import enable_compile_cache
from diffusion_torch.utils.device import rank_and_world

__all__ = ["train", "build_trainer"]


def _build_loggers(config: Dict[str, Any]):
    """Instantiate logger destinations; wandb gets name/project/group and the
    resolved config attached (reference train.py:70-84)."""
    loggers = []
    for key, conf in (config.get("logger") or {}).items():
        if conf is None:
            continue
        if key == "wandb":
            loggers.append(instantiate(conf, config=config))
        else:
            loggers.append(instantiate(conf))
    return loggers


def build_trainer(config: Dict[str, Any]) -> Trainer:
    seed = int(config.get("seed", 17))
    np.random.seed(seed)
    trainer_conf = dict(config.get("trainer") or {})
    if dist.initialize() and trainer_conf.get("mesh_config"):
        trainer_conf["mesh"] = create_mesh(**trainer_conf.pop("mesh_config"))

    model = instantiate(config["model"])

    # optimizer spec: accept torch-style AdamW nodes by reading lr/weight_decay
    opt_conf = dict(config.get("optimizer") or {})
    opt_conf.pop("_target_", None)
    optimizer = adamw(lr=opt_conf.get("lr", 1e-4),
                      betas=opt_conf.get("betas", (0.9, 0.999)),
                      eps=opt_conf.get("eps", 1e-8),
                      weight_decay=opt_conf.get("weight_decay", 0.01),
                      mu_dtype=opt_conf.get("mu_dtype"))

    # data: builders receive batch sizes divided per process (reference
    # train.py:40 divides by the world size)
    dataset_conf = config.get("dataset") or {}
    world = rank_and_world()[1]
    train_dataloader = None
    if dataset_conf.get("train_dataset"):
        tb = int(dataset_conf.get("train_batch_size", 0) or
                 select(dataset_conf, "train_dataset.batch_size", 0))
        if tb < world or tb % world:
            # Composer raises the same way (reference train.py:40)
            raise ValueError(
                f"train_batch_size {tb} must be a positive multiple of "
                f"the world size ({world})")
        train_dataloader = instantiate(dataset_conf["train_dataset"],
                                       batch_size=tb // world,
                                       _recursive_=False)

    evaluators = []
    if dataset_conf.get("evaluators"):
        for ev_conf in dataset_conf["evaluators"]:
            eb = int(ev_conf.get("eval_batch_size")
                     or dataset_conf.get("eval_batch_size") or 8)
            dl = instantiate(ev_conf["eval_dataset"], batch_size=eb // world)
            evaluators.append(Evaluator(ev_conf.get("label", "eval"), dl,
                                        ev_conf.get("metric_names", ())))
    elif dataset_conf.get("eval_dataset"):
        eb = int(dataset_conf.get("eval_batch_size", 8) or 8)
        dl = instantiate(dataset_conf["eval_dataset"], batch_size=eb // world)
        evaluators.append(Evaluator(
            "eval", dl, getattr(model, "val_metric_names", ())))

    loggers = _build_loggers(config)

    algorithms = [instantiate(c) for c in (config.get("algorithms") or {}).values()
                  if c is not None]
    callbacks = [instantiate(c) for c in (config.get("callbacks") or {}).values()
                 if c is not None]

    trainer_conf.pop("_target_", None)
    max_duration = trainer_conf.get("max_duration", "1ba")
    scale_schedule_ratio = float(config.get(
        "scale_schedule_ratio", trainer_conf.pop("scale_schedule_ratio", 1.0)))

    # epoch-denominated times ('200ep') resolve against the dataloader's
    # length, as Composer resolves them from len(train_dataloader)
    # (reference train.py:116); a loader without a length leaves
    # batches_per_epoch=0 and epoch milestones unreachable (skipped)
    batches_per_epoch = 0
    if train_dataloader is not None:
        try:
            batches_per_epoch = int(len(train_dataloader))
        except TypeError:
            batches_per_epoch = 0
    sched_conf = dict(config.get("scheduler") or {})
    if sched_conf:
        target = sched_conf.pop("_target_", None)
        name = sched_conf.pop("name", None)
        if target:
            # hydra parity: an explicit _target_ wins over the name
            factory = _import_target(target)
        else:
            factory = getattr(optim_mod, name) if name else \
                optim_mod.multi_step_with_warmup if "milestones" in sched_conf \
                else optim_mod.constant_with_warmup
        sched_conf.setdefault("batches_per_epoch", batches_per_epoch)
        schedule = factory(max_duration=max_duration,
                           scale_schedule_ratio=scale_schedule_ratio,
                           **sched_conf)
    else:
        schedule = constant_scheduler()

    trainer_conf.setdefault("run_name", config.get("name") or "run")
    trainer_conf.setdefault("seed", seed)
    return Trainer(
        model=model,
        train_dataloader=train_dataloader,
        eval_dataloader=evaluators or None,
        optimizers=optimizer,
        schedulers=schedule,
        loggers=loggers,
        algorithms=algorithms,
        callbacks=callbacks,
        scale_schedule_ratio=scale_schedule_ratio,
        **trainer_conf,
    )


def train(config: Dict[str, Any]) -> Trainer:
    """Full composition + eval-first + fit (reference train.py:130-138)."""
    enable_compile_cache(config.get("compile_cache_dir"))
    trainer = build_trainer(config)
    try:
        if config.get("eval_first") and trainer.evaluators:
            trainer.eval(subset_num_batches=select(
                config, "trainer.eval_subset_num_batches", -1))
        trainer.fit()
    finally:
        trainer.close()
    return trainer
