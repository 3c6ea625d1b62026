"""The raw-image training step's share of the card's bf16 peak, in %: the
plain reference's FLOPs a sample (the UNet's loss forward and backward,
the VAE encoder over the image, CLIP over its token ids) x the window's
samples/s / 989 TFLOP/s."""

from portbench.flops import PEAK_FLOPS
from portbench.flops_mmdit import wds_train_flops


def read(run):
    w, t = run.window, run.traffic
    if not w.get("seconds") or not w.get("samples"):
        return None
    if "vae" not in run.config or "text_encoder" not in run.config:
        return None
    per_sample = wds_train_flops(run.config, t["microbatch"],
                                 t["resize_size"], t["caption_tokens"]
                                 ) / t["microbatch"]
    return 100.0 * per_sample * w["samples"] / w["seconds"] / PEAK_FLOPS
