"""The share of the traced window (wall time, between synchronizations) in
which no operation ran on the device, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
