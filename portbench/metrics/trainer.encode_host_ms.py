"""Host ms a training step in `StableDiffusion.forward`'s `encode` spans
(the VAE encoder and CLIP over the microbatches' raw images and token
ids, inside `forward`), from the program's span recorder, over the
untraced window's steps but its last. Silent on a program without the
span."""


def read(run):
    try:
        from diffusion_torch.utils.profiler import recorder
    except ImportError:      # a program that records no spans
        return None
    first = run.traffic["checked_steps"]
    # the window's steps but its last, whose end holds the closing
    # synchronize
    stop = first + run.window.get("steps", 0) - 1
    records = recorder.steps(first, stop) if stop > first else []
    if not any(s.name == "encode" for r in records for s in r.spans):
        return None
    ns = sum(r.total_ns("encode") for r in records)
    return ns / 1e6 / len({r.step for r in records})
