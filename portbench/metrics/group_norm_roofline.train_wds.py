"""The GroupNorm kernels' share of their roofline over the raw-image
cell's traced training steps, in %: the least time of the UNet's GroupNorm
calls, forward and backward, and of the VAE encoder's, forward only (the
encoder is frozen), over the device time of gn_fwd_kernel and
gn_bwd_kernel. Silent unless the program's GroupNorm call counters over
the traced steps equal those calls (a call may take two launches)."""

from portbench.flops import group_norm_bound_s, traced_share, unet_calls
from portbench.flops_mmdit import encoder_norms

KERNELS = ("gn_fwd_kernel", "gn_bwd_kernel")


def read(run):
    t, w = run.traffic, run.window
    passes = w.get("traced_steps", 0) * t["batch_size"] // t["microbatch"]
    calls = w.get("group_norm_calls")
    if not passes or not calls or "vae" not in run.config:
        return None
    unet, _ = unet_calls(run.config["unet"], t["microbatch"],
                         t["latent_side"], t["caption_tokens"])
    encoder = encoder_norms(run.config, t["microbatch"], t["resize_size"])
    if calls != {"forward": passes * (len(unet) + len(encoder)),
                 "backward": passes * len(unet)}:
        return None
    bound = passes * (sum(group_norm_bound_s(s, False)
                          + group_norm_bound_s(s, True) for s in unet)
                      + sum(group_norm_bound_s(s, False) for s in encoder))
    return traced_share(run, KERNELS, bound)
