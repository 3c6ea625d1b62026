"""COCO eval at several guidance scales (the multi-scale protocol).

Counterpart of `scripts/coco_eval.py`, with the same flags and `--device`
(CUDA unless `--device cpu`): the COCO val reader and a model with FID and
CLIPScore at each of `--guidance_scales`, evaluated once by
`Trainer.eval()`, with the model's own sampler (DDIM).

  python -m diffusion_torch.scripts.coco_eval --remote <coco-mds> \\
      [--guidance_scales 1.0 3.0 7.0] [--load_path <ckpt-dir>]
"""

from __future__ import annotations

import argparse

_DEFAULT_BUILDER = "diffusion_torch.models.models.stable_diffusion_2"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--remote", required=True)
    p.add_argument("--local", default=None)
    p.add_argument("--load_path", default=None)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--guidance_scales", type=float, nargs="+",
                   default=[1.0, 3.0, 7.0])
    p.add_argument("--subset_num_batches", type=int, default=-1)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--builder", default=_DEFAULT_BUILDER,
                   help="model builder dotted path (the tiny builder runs "
                        "the multi-scale protocol at test size)")
    p.add_argument("--allow_random_towers", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, raising without it)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from diffusion_torch.config.loader import _import_target
    from diffusion_torch.data.coco import build_streaming_cocoval_dataloader
    from diffusion_torch.train.trainer import Evaluator, Trainer
    from diffusion_torch.utils.logging import ConsoleLogger

    loader = build_streaming_cocoval_dataloader(
        remote=args.remote, local=args.local, batch_size=args.batch_size,
        resize_size=args.size, tokenizer_name_or_path=args.tokenizer)
    model = _import_target(args.builder)(
        model_name=args.tokenizer, pretrained=False,
        val_metrics=["FrechetInceptionDistance", "CLIPScore"],
        allow_random_tower_weights=args.allow_random_towers,
        val_guidance_scales=list(args.guidance_scales), device=args.device)
    trainer = Trainer(
        model=model,
        eval_dataloader=[Evaluator("coco-val", loader,
                                   model.val_metric_names)],
        loggers=[ConsoleLogger(log_interval=1)],
        load_path=args.load_path, load_weights_only=True,
        image_size=args.size, max_duration="1ba",
        eval_subset_num_batches=args.subset_num_batches,
        eval_num_inference_steps=args.num_inference_steps,
        device=args.device)
    try:
        results = trainer.eval()
    finally:
        trainer.close()
    for k, v in sorted(results.items()):
        print(f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
