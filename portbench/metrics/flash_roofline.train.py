"""The flash kernels' share of their roofline over the traced training
steps, in %: the least time of the attention calls the configuration
sends to flash (2 units forward, 4 backward) over the device time of
flash_fwd_kernel, flash_bwd_dq_kernel and flash_bwd_dkv_kernel. Silent
where the launches are not one of each per call."""

from portbench.flops import flash_bound_s, flash_calls, traced_share

KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")


def read(run):
    t = run.traffic
    passes = run.window["traced_steps"] * t["batch_size"] // t["microbatch"]
    calls = flash_calls(run.config["unet"], t["microbatch"],
                        t["latent_side"], t["caption_tokens"])
    if not passes or not calls:
        return None
    bound = passes * sum(flash_bound_s(c, False) + flash_bound_s(c, True)
                         for c in calls)
    n = passes * len(calls)
    return traced_share(run, KERNELS, bound, {k: n for k in KERNELS})
