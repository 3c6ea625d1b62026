"""Low-precision norm "algorithms": the yaml surface of the reference.

Counterpart of `diffusion_tpu/algorithms/low_precision.py`. The reference
applies composer's module-surgery algorithms `low_precision_groupnorm` /
`low_precision_layernorm` to `model.unet` (reference: diffusion/train.py:
86-108, yamls/hydra-yamls/SD-2-base-256.yaml:7-13) so norms run in fp16
autocast with fp32 params.

In the port, as in the JAX package, that is the networks' default policy:
every GroupNorm/LayerNorm in `models/layers.py` keeps fp32 parameters and
fp32 statistics and returns the module's compute dtype (bf16 for SD-2-base).
These classes keep the yaml's `algorithms:` block working: at INIT they log
the two hyperparameters and rewrite nothing.
"""

from __future__ import annotations

from diffusion_torch.train.events import Algorithm, Event

__all__ = ["LowPrecisionGroupNorm", "LowPrecisionLayerNorm"]


class _LowPrecisionNorm(Algorithm):
    def __init__(self, attribute: str = "unet", precision: str = "amp_bf16"):
        self.attribute = attribute
        self.precision = precision

    def match(self, event: Event, state) -> bool:
        return event == Event.INIT

    def apply(self, event: Event, state, logger) -> None:
        # fp16 requested -> bf16 delivered, as in the JAX package
        if logger is not None:
            logger.log_hyperparameters({
                f"algorithms/{type(self).__name__}/attribute": self.attribute,
                f"algorithms/{type(self).__name__}/precision": "amp_bf16",
            })


class LowPrecisionGroupNorm(_LowPrecisionNorm):
    pass


class LowPrecisionLayerNorm(_LowPrecisionNorm):
    pass
