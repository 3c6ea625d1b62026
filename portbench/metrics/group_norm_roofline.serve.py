"""The GroupNorm forward kernel's share of its roofline over the traced
burst, in %: the least time of the GroupNorm calls of the burst's UNet
calls and VAE decodes, over the device time of gn_fwd_kernel."""

from portbench.flops import decode_norms, group_norm_bound_s, \
    traced_share, unet_calls


def read(run):
    t, w = run.traffic, run.window
    side, tokens = t["size"] // 8, \
        run.config["text_encoder"]["max_position_embeddings"]
    shapes = [s for b in w.get("unet_batches", [])
              for s in unet_calls(run.config["unet"], b, side, tokens)[0]]
    shapes += [s for b in w.get("decode_batches", [])
               for s in decode_norms(run.config, b, side)]
    if not shapes:
        return None
    bound = sum(group_norm_bound_s(s, False) for s in shapes)
    return traced_share(run, ("gn_fwd_kernel",), bound)
