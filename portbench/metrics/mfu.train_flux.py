"""The FLUX training step's share of the card's bf16 peak: the model's
FLOPs a sample (the plain reference's count, forward and backward, the
joint attention as matmuls at its true length) x the window's samples/s /
989 TFLOP/s, in %."""

from portbench.flops import PEAK_FLOPS
from portbench.flops_flux import flux_train_flops


def read(run):
    w, t = run.window, run.traffic
    if not w.get("seconds") or not w.get("samples"):
        return None
    per_sample = flux_train_flops(run.config["transformer"], 1,
                                  t["latent_side"], t["caption_tokens"])
    return 100.0 * per_sample * w["samples"] / w["seconds"] / PEAK_FLOPS
