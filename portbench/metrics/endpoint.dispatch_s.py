"""Seconds a dispatch (`predict_many`: tokenize, CLIP, the CFG DDIM loop,
the VAE decode, the PNGs) over the window: the change in the batcher's
`dispatch_seconds_total` over the change in `dispatches_total`."""


def read(run):
    s = run.stats
    if not s.get("dispatches_total"):
        return None
    return s["dispatch_seconds_total"] / s["dispatches_total"]
