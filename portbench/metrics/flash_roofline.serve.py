"""The flash forward kernel's share of its roofline over the traced burst,
in %: the least time of the attention calls the UNet calls of the burst
send to flash (2 units each), over the device time of flash_fwd_kernel.
Silent where the launches are not one per call."""

from portbench.flops import flash_bound_s, flash_calls, traced_share


def read(run):
    t = run.traffic
    side, tokens = t["size"] // 8, \
        run.config["text_encoder"]["max_position_embeddings"]
    calls = [c for b in run.window.get("unet_batches", [])
             for c in flash_calls(run.config["unet"], b, side, tokens)]
    if not calls:
        return None
    bound = sum(flash_bound_s(c, False) for c in calls)
    return traced_share(run, ("flash_fwd_kernel",), bound,
                        {"flash_fwd_kernel": len(calls)})
