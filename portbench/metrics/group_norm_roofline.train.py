"""The GroupNorm kernels' share of their roofline over the traced training
steps, in %: the least time of the UNet's GroupNorm calls, forward and
backward, over the device time of gn_fwd_kernel and gn_bwd_kernel."""

from portbench.flops import group_norm_bound_s, traced_share, unet_calls

KERNELS = ("gn_fwd_kernel", "gn_bwd_kernel")


def read(run):
    t = run.traffic
    passes = run.window["traced_steps"] * t["batch_size"] // t["microbatch"]
    norms, _ = unet_calls(run.config["unet"], t["microbatch"],
                          t["latent_side"], t["caption_tokens"])
    if not passes:
        return None
    bound = passes * sum(group_norm_bound_s(s, False)
                         + group_norm_bound_s(s, True) for s in norms)
    return traced_share(run, KERNELS, bound)
