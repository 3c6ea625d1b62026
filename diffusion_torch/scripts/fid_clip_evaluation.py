"""Offline FID + CLIPScore evaluation on COCO-2014-val.

Counterpart of `scripts/fid_clip_evaluation.py` (the reference's offline
eval script, run by `yamls/eval.yaml`), with the same flags and `--device`
(CUDA unless `--device cpu`): the COCO val reader
(`diffusion_torch/data/coco.py`), a model with FID and CLIPScore at one
guidance scale and `--scheduler` as its sampler, a checkpoint loaded
weights-only, one `Trainer.eval()`, and 10 fixed prompts' images through
`LogDiffusionImages`. The results go to `--out` as jsonl records.

  python -m diffusion_torch.scripts.fid_clip_evaluation --remote <coco-mds> \\
      --load_path <ckpt-dir> --guidance_scale 3.0 [--size 256] [--seed 42]

The towers' weights come from `DIFFUSION_TPU_INCEPTION_WEIGHTS` and
`DIFFUSION_TPU_CLIP_WEIGHTS` (`metrics/towers.py`); without them the run
refuses unless `--allow_random_towers`.
"""

from __future__ import annotations

import argparse

PROMPTS = [
    "a couple waiting to cross the street",
    "a kitchen with a refrigerator, stove and sink",
    "a man riding skis down a snow covered slope",
    "a group of people standing on a beach flying kites",
    "a bathroom with a toilet, sink and mirror",
    "two giraffes standing next to each other in a field",
    "a bus driving down a city street next to tall buildings",
    "a plate of food with broccoli and meat",
    "a baseball player swinging a bat at a ball",
    "a vase filled with flowers on a table",
]

_DEFAULT_BUILDER = "diffusion_torch.models.models.stable_diffusion_2"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--remote", required=True)
    p.add_argument("--local", default=None)
    p.add_argument("--load_path", default=None)
    p.add_argument("--guidance_scale", type=float, default=3.0)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=1138)
    p.add_argument("--subset_num_batches", type=int, default=-1)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--builder", default=_DEFAULT_BUILDER,
                   help="model builder dotted path (the tiny builder runs "
                        "the whole protocol at test size)")
    p.add_argument("--allow_random_towers", action="store_true",
                   help="permit random metric-tower weights (smoke runs "
                        "only: FID numbers are meaningless without real "
                        "towers)")
    p.add_argument("--scheduler", default="ddim",
                   choices=["ddim", "dpm++2m", "euler"],
                   help="sampler for the eval's generation")
    p.add_argument("--out", default="eval_metrics.jsonl")
    p.add_argument("--wandb", action="store_true",
                   help="log to wandb (no-op if wandb is not installed)")
    p.add_argument("--project", default="diffusion-eval")
    p.add_argument("--name", default="fid-clip-evaluation")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, raising without it)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from diffusion_torch.callbacks.log_diffusion_images import \
        LogDiffusionImages
    from diffusion_torch.config.loader import _import_target
    from diffusion_torch.data.coco import build_streaming_cocoval_dataloader
    from diffusion_torch.train.trainer import Evaluator, Trainer
    from diffusion_torch.utils.logging import (ConsoleLogger, FileLogger,
                                               WandBLogger)

    loader = build_streaming_cocoval_dataloader(
        remote=args.remote, local=args.local, batch_size=args.batch_size,
        resize_size=args.size, tokenizer_name_or_path=args.tokenizer)
    model = _import_target(args.builder)(
        model_name=args.tokenizer, pretrained=False,
        val_metrics=["FrechetInceptionDistance", "CLIPScore"],
        val_guidance_scales=[args.guidance_scale], val_seed=args.seed,
        allow_random_tower_weights=args.allow_random_towers,
        inference_scheduler=args.scheduler, fsdp=True, device=args.device)
    loggers = [ConsoleLogger(log_interval=1), FileLogger(args.out)]
    if args.wandb:
        loggers.append(WandBLogger(
            project=args.project,
            name=args.name + ("" if args.load_path else "-pretrained")))
    trainer = Trainer(
        model=model,
        eval_dataloader=[Evaluator("coco-val", loader,
                                   model.val_metric_names)],
        loggers=loggers,
        callbacks=[LogDiffusionImages(PROMPTS, size=args.size,
                                      guidance_scale=args.guidance_scale,
                                      seed=args.seed)],
        load_path=args.load_path, load_weights_only=True,
        image_size=args.size, max_duration="1ba",
        eval_num_inference_steps=args.num_inference_steps,
        eval_subset_num_batches=args.subset_num_batches, device=args.device)
    try:
        results = trainer.eval()
    finally:
        trainer.close()      # flushes the records to --out
    for k, v in sorted(results.items()):
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
