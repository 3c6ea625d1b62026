"""Device ms a training step of the optimizer's and the EMA's foreach
kernels (the "optimizer/EMA foreach" category), over the traced steps."""

from portbench.trace import category


def read(run):
    tr, steps = run.trace, run.window["traced_steps"]
    if tr is None or not steps:
        return None
    s = sum(e - b for b, e, n in tr.ops
            if category(n) == "optimizer/EMA foreach")
    return 1e3 * s / steps if s > 0 else None
