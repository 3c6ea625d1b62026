"""The share of the wds reader's decoded samples whose image a loader
worker decoded, in %: over the untraced window's steps but its last, the
growth of the program's `data.datapipes.decoded_in_workers` over that and
`decoded_inline` (samples decoded on the training thread), from the step
records of its span recorder. Silent where the program has no such
counters or step records without counts, or the window decoded no
sample."""


def read(run):
    try:
        from diffusion_torch.data.datapipes import (decoded_in_workers,
                                                    decoded_inline)
        from diffusion_torch.utils.profiler import StepRecord, recorder
    except ImportError:      # a program that decodes on the training thread
        return None
    if not hasattr(StepRecord, "launches"):
        return None
    first = run.traffic["checked_steps"]
    # the window's steps but its last, whose end holds the closing
    # synchronize
    stop = first + run.window.get("steps", 0) - 1
    records = recorder.steps(first, stop) if stop > first else []
    workers = sum(r.launches(decoded_in_workers) for r in records)
    inline = sum(r.launches(decoded_inline) for r in records)
    return 100.0 * workers / (workers + inline) if workers + inline else None
