"""Requests merged into a dispatch over the window: the change in the
batcher's `requests_total` over the change in `dispatches_total`, from
`GET /stats`."""


def read(run):
    s = run.stats
    if not s.get("dispatches_total"):
        return None
    return s["requests_total"] / s["dispatches_total"]
