"""Config loading and `_target_` composition (a copy of the JAX package's)."""

from diffusion_torch.config.loader import (apply_overrides, instantiate,
                                           load_config, loads_config, merge,
                                           resolve, select, to_yaml)

__all__ = ["apply_overrides", "instantiate", "load_config", "loads_config",
           "merge", "resolve", "select", "to_yaml"]
