"""torch.cuda.max_memory_allocated() over the measured window (reset as it
opens), in GiB."""


def read(run):
    peak = run.window.get("peak_bytes", 0)
    return peak / 2 ** 30 if peak > 0 else None
