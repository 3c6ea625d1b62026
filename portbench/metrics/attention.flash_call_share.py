"""The share of the window's attention calls (`multi_head_attention`; the
MMDiT's are all joint) that ran on the flash kernels, in %: the growth of
the program's `ops.attention.flash_calls` over that of it and
`plain_calls`, from the window's opening to its closing (a replayed step
adds its captured calls). Silent where the program has no such counts."""


def read(run):
    calls = run.window.get("attention_calls") or {}
    if "flash_calls" not in calls or "plain_calls" not in calls:
        return None
    total = calls["flash_calls"] + calls["plain_calls"]
    return 100.0 * calls["flash_calls"] / total if total else None
