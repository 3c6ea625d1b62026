"""Host ms a training step in the flash and GroupNorm kernel wrappers (from
entry to the launch's return: checks, plans, output allocations, the
ctypes call): how far their `LaunchCounter`s' summed host time grew over
each step, from the program's span recorder, over the untraced window's
steps but its last. Inside the `forward` and `backward` spans."""


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
    ns = sum(r.wrapper_host_ns for r in records)
    return ns / 1e6 / len({r.step for r in records})
