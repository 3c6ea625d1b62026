"""The share of the trained weights' gradient accumulations that ran
through the step's bf16 working copies, in %: over the untraced window's
steps but its last, the growth of the program's
`ops.working_copy.accumulations` (gradients the op's own pass added into
`.grad`) over that and `fallbacks` (gradients that reached `.grad` by a
per-call cast or in a layout the pass does not take), from the step
records of its span recorder (a replayed step counts what its graph
captured). Silent where the program has no working copies or step records
without counts, or the window no accumulation."""


def read(run):
    try:
        from diffusion_torch.ops.working_copy import accumulations, fallbacks
        from diffusion_torch.utils.profiler import StepRecord, recorder
    except ImportError:      # a program without working copies
        return None
    if not hasattr(StepRecord, "launches"):
        return None
    first = run.traffic["checked_steps"]
    # the window's steps but its last, whose end holds the closing
    # synchronize
    stop = first + run.window.get("steps", 0) - 1
    records = recorder.steps(first, stop) if stop > first else []
    fused = sum(r.launches(accumulations) for r in records)
    other = sum(r.launches(fallbacks) for r in records)
    return 100.0 * fused / (fused + other) if fused + other else None
