"""The share of the training steps whose forward and backward were replayed
from the step's CUDA graph, in %: the steps that hold a `replay` span, from
the program's span recorder, over the untraced window's steps but its last.
Silent where the program has no step graph (no `step_graph` counts beside
its spans) or the window no steps."""


def read(run):
    try:
        from diffusion_torch.utils.profiler import recorder, step_graph
    except ImportError:      # a program without spans or a step graph
        return None
    del step_graph
    first = run.traffic["checked_steps"]
    # the window's steps but its last, whose end holds the closing
    # synchronize
    stop = first + run.window.get("steps", 0) - 1
    records = recorder.steps(first, stop) if stop > first else []
    if not records:
        return None
    steps = {r.step for r in records}
    replayed = {r.step for r in records
                if any(s.name == "replay" for s in r.spans)}
    return 100.0 * len(replayed) / len(steps)
