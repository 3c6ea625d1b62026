"""The dispatches' share of the card's bf16 peak over the window: the
model's FLOPs for the requests served (the plain reference's count: CLIP
text twice, the CFG UNet steps, one VAE decode) over the dispatches' own
seconds (the batcher's `dispatch_seconds_total`) / 989 TFLOP/s, in %."""

from portbench.flops import PEAK_FLOPS, serve_flops_per_image


def read(run):
    s, t = run.stats, run.traffic
    if not s.get("dispatch_seconds_total") or not s.get("requests_total"):
        return None
    per_image = serve_flops_per_image(run.config, t["size"], t["steps"])
    return (100.0 * per_image * s["requests_total"]
            / s["dispatch_seconds_total"] / PEAK_FLOPS)
