"""The flash kernels' share of their roofline over the MMDiT's traced
training steps, in %: the least time of the joint attention calls at
their true lengths (4,096 image + 154 text tokens at 1,024px; 2 units
forward, 4 backward) over the device time of flash_fwd_kernel,
flash_bwd_dq_kernel and flash_bwd_dkv_kernel. Silent unless each kernel's
traced launches, and the program's tail counters over the traced steps,
equal the calls."""

from portbench.flops import flash_bound_s, traced_share
from portbench.flops_mmdit import joint_calls

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(run):
    t, w = run.traffic, run.window
    passes = w["traced_steps"] * t["batch_size"] // t["microbatch"]
    calls = joint_calls(run.config["transformer"], t["microbatch"],
                        t["latent_side"], t["caption_tokens"])
    if not passes or not calls:
        return None
    n = passes * len(calls)
    tails = w.get("tail_launches")
    ragged = calls[0][2] % 64 or calls[0][3] % 64
    if ragged and (not tails or any(v != n for v in tails.values())):
        return None
    bound = passes * sum(flash_bound_s(c, False) + flash_bound_s(c, True)
                         for c in calls)
    return traced_share(run, KERNELS, bound, {k: n for k in KERNELS})
