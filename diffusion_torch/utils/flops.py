"""FLOP accounting for throughput/MFU reporting.

Counterpart of `diffusion_tpu/utils/flops.py`. Composer's SpeedMonitor logs
`throughput/flops_per_sec` and `throughput/device/mfu` when the run gives
it `flops_per_batch`; here that number is counted from one execution of the
step under a dispatch mode (`torch.utils.flop_counter.FlopCounterMode`),
which sees every matrix product and convolution the step dispatches, with
the recompute of a rematerialized backward: the executed work, as JAX's
post-AD jaxpr has it.

A dispatch mode does not see inside a dispatcher op, so the port's flash
ops are priced by formulas that follow the kernels' own work. A unit is
2·B·H·Sq·Skv·D, one (Sq x D) @ (D x Skv)-sized product over the batch and
heads:

- `diffusion_torch::flash_attention`: 2 units (QK^T, PV);
- `diffusion_torch::flash_attention_bwd`: 3 units for the dQ kernel (S
  recomputed, dP, dQ) and 4 for dK/dV (S, dV, dP^T, dK);
- `diffusion_torch::ring_attention`: 2 units for each of its n blocks (n
  the sp group's size); its backward runs each block through the backward
  op, which is counted as it runs.

They are priced whatever the device, so one step counts the same on the
CPU and on the card. GroupNorm counts 0, as in JAX. A convolution counts
its useful work, its input gradient included: the reference's counter
prices a strided convolution's input gradient at stride² times that work
(it counts the zeros of the lhs dilation), the port's does not. JAX prices
the dK/dV kernel at 3 units; its body does 4 products.

`route_meta_as("cuda")` (`utils/device.py`) lets a model built on the meta
device take the card's routes, so the card's count comes without a card
and without data; `route_meta_as("cpu")` the CPU's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["lowered_flops", "traced_flops", "flops_by_class",
           "device_peak_flops", "attention_unit", "FLASH_FWD_UNITS",
           "FLASH_BWD_DQ_UNITS", "FLASH_BWD_DKV_UNITS"]

FLASH_FWD_UNITS = 2
FLASH_BWD_DQ_UNITS = 3
FLASH_BWD_DKV_UNITS = 4


def attention_unit(q_shape, k_shape) -> int:
    """2·B·H·Sq·Skv·D for (B, Sq, H, D) queries and (B, Skv, H, D) keys."""
    b, sq, h, d = q_shape
    return 2 * b * h * sq * k_shape[1] * d


def _flash_fwd(q, k, *args, out_shape=None, **kwargs) -> int:
    return FLASH_FWD_UNITS * attention_unit(q, k)


def _flash_bwd(q, k, *args, out_shape=None, **kwargs) -> int:
    return (FLASH_BWD_DQ_UNITS + FLASH_BWD_DKV_UNITS) * attention_unit(q, k)


def _ring_fwd(q, k, v, group, *args, out_shape=None, **kwargs) -> int:
    import torch.distributed as dist

    from diffusion_torch.parallel.sharding import process_group
    n = dist.get_world_size(process_group(group))
    return n * FLASH_FWD_UNITS * attention_unit(q, k)


def _formulas() -> Dict[Any, Callable]:
    # importing the ops registers them with the dispatcher
    import diffusion_torch.ops.flash_attention  # noqa: F401
    import diffusion_torch.ops.ring_attention  # noqa: F401
    ops = torch.ops.diffusion_torch
    return {ops.flash_attention: _flash_fwd,
            ops.flash_attention_bwd: _flash_bwd,
            ops.ring_attention: _ring_fwd}


def _class(packet) -> str:
    name = str(packet)
    if name.startswith("diffusion_torch."):
        return "flash"
    return "conv" if "conv" in name else "dot"


def _count(fn: Callable, args, kwargs) -> FlopCounterMode:
    counter = FlopCounterMode(display=False, custom_mapping=_formulas())
    with counter:
        fn(*args, **kwargs)
    return counter


def flops_by_class(fn: Callable, *args: Any, **kwargs: Any) -> dict:
    """FLOPs of one `fn(*args, **kwargs)` execution split {'dot', 'conv',
    'flash'}: matrix products, convolutions (forward and backward) and the
    port's flash ops (the counterpart of `jaxpr_flops_by_class`). `fn`
    runs: a training step's FLOPs come from a function that calls
    `backward()`."""
    out = {"dot": 0.0, "conv": 0.0, "flash": 0.0}
    counts = _count(fn, args, kwargs).get_flop_counts().get("Global", {})
    for packet, flops in counts.items():
        out[_class(packet)] += float(flops)
    return out


def traced_flops(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """Executed FLOPs of matrix products, convolutions and the flash ops
    for one `fn(*args, **kwargs)` call: the sum of `flops_by_class`."""
    return sum(flops_by_class(fn, *args, **kwargs).values())


def lowered_flops(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """The total of torch's own `FlopCounterMode` over one call, with the
    port's flash formulas registered. JAX's `lowered_flops` is XLA's cost
    analysis of the lowered program, which prices every HLO op it can see
    (elementwise work too) and not the Pallas kernels; torch's counter
    prices the products, convolutions and attention ops in its registry,
    so here it equals `traced_flops`."""
    return float(_count(fn, args, kwargs).get_total_flops())


# Dense bf16 peak FLOP/s by `torch.cuda.get_device_name`, from NVIDIA's H100
# data sheet (no sparsity); None for any other device: MFU is then not
# reported, never fabricated
_PEAKS = {
    "H100 80GB HBM3": 989e12,     # SXM5
    "H100 PCIe": 756e12,
}


def device_peak_flops(device: Optional[Any] = None) -> Optional[float]:
    """The bf16 peak FLOP/s of `device` (default: the current CUDA
    device), or None where the card is not in the table or the device is
    not a card."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAKS.items():
        if key in name:
            return peak
    return None
