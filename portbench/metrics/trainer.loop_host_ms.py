"""Host ms a training step outside `forward`, `backward` and `update`: the
`step` span's self time and its `data` child (the loader, the events and
callbacks, logging, the loop), from the program's span recorder, over the
untraced window's steps but its last. With the three others it sums to
the `step` spans' time."""


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
    ns = sum(r.root.duration_ns - r.total_ns("forward")
             - r.total_ns("backward") - r.total_ns("update")
             for r in records)
    return ns / 1e6 / len({r.step for r in records})
