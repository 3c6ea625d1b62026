"""CLI entry: compose a training run from a yaml and run it with the port.

    python -m diffusion_torch.run --config-path yamls \
        --config-name SD-2-base-256.yaml [dotted.overrides=...]

The counterpart of the repository's `run.py` (reference run.py:14-22, a
hydra wrapper): it errors when no config is given, and overrides use the
same key=value syntax. The yamls' `diffusion_tpu.*` `_target_`s compose the
port's modules. The run is on CUDA; a tiny-geometry yaml runs on the CPU
with `+model.device=cpu +trainer.device=cpu`.
"""

import argparse
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="diffusion_torch training entry")
    parser.add_argument("--config-path", required=False, help="config directory")
    parser.add_argument("--config-name", required=False, help="config yaml name")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    if not args.config_path or not args.config_name:
        raise ValueError("Please specify --config-path and --config-name "
                         "(reference parity: run.py requires an explicit config)")

    from diffusion_torch.config import load_config
    from diffusion_torch.train.train import train

    name = args.config_name
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    config = load_config(os.path.join(args.config_path, name), args.overrides)
    train(config)


if __name__ == "__main__":
    main()
