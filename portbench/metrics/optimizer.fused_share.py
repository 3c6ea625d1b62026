"""The share of the training steps whose optimizer update ran as the one
fused AdamW (+ EMA) kernel pass, in %: the steps that hold a
`fused_update` span, from the program's span recorder, over the untraced
window's steps but its last. Silent where the program has no such kernel
(no `diffusion_torch.ops.adamw`) or the window no steps."""


import importlib


def read(run):
    try:
        importlib.import_module("diffusion_torch.ops.adamw")
        from diffusion_torch.utils.profiler import recorder
    except ImportError:      # a program without spans or the fused kernel
        return None
    first = run.traffic["checked_steps"]
    # the window's steps but its last, whose end holds the closing
    # synchronize
    stop = first + run.window.get("steps", 0) - 1
    records = recorder.steps(first, stop) if stop > first else []
    if not records:
        return None
    steps = {r.step for r in records}
    fused = {r.step for r in records
             if any(s.name == "fused_update" for s in r.spans)}
    return 100.0 * len(fused) / len(steps)
