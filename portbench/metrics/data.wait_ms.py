"""Host ms a training step waiting for its batch: the Trainer's `data`
spans (the loader's next batch: here the wds reader's read, decode, resize
and tokenize on the training thread), from the program's span recorder,
over the untraced window's steps but its last."""


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
    if not records:
        return None
    ns = sum(r.total_ns("data") for r in records)
    return ns / 1e6 / len({r.step for r in records})
