"""The training step's share of the card's bf16 peak: the model's FLOPs a
sample (the plain reference's count, forward and backward) x the window's
samples/s / 989 TFLOP/s, in %."""

from portbench.flops import PEAK_FLOPS, train_flops


def read(run):
    w, t = run.window, run.traffic
    if not w.get("seconds") or not w.get("samples"):
        return None
    per_sample = train_flops(run.config["unet"], t["microbatch"],
                             t["latent_side"], t["caption_tokens"]
                             ) / t["microbatch"]
    return 100.0 * per_sample * w["samples"] / w["seconds"] / PEAK_FLOPS
