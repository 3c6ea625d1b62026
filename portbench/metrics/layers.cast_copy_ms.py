"""Device ms a training step of copies and casts (the "copies and casts"
category: the layers' per-call weight casts among them), over the traced
steps."""

from portbench.trace import category


def read(run):
    tr, steps = run.trace, run.window["traced_steps"]
    if tr is None or not steps:
        return None
    s = sum(e - b for b, e, n in tr.ops if category(n) == "copies and casts")
    return 1e3 * s / steps if s > 0 else None
