"""The head-dim-128 flash dQ kernel's share of its roofline over FLUX's
traced training steps, in %: the least time of the joint attention calls
(512 text + 4,096 image tokens at 1,024px, one a block) over the device
time of flash_bwd_dq_kernel's d = 128 instance. A kernel's least time is
its own work, as PERF.md section 6 prices the three: 3 units (S again,
dP, dQ), three quarters of `flash_bound_s(call, True)`, whose 4 units are
the backward's model work (the tensor cores bound both at these shapes).
Silent unless the instance's traced launches, and the program's `dq`
head-dim-128 counter over the traced steps, equal the calls."""

from portbench.flops import flash_bound_s, traced_share
from portbench.flops_flux import joint_calls

KERNEL = "flash_bwd_dq_kernel<128"
SHARE = 0.75
BACKWARD = True


def read(run):
    t, w = run.traffic, run.window
    passes = w["traced_steps"] * t["batch_size"] // t["microbatch"]
    calls = joint_calls(run.config["transformer"], t["microbatch"],
                        t["latent_side"], t["caption_tokens"])
    if not passes or not calls:
        return None
    n = passes * len(calls)
    if (w.get("d128_launches") or {}).get("dq") != n:
        return None
    bound = passes * sum(SHARE * flash_bound_s(c, BACKWARD) for c in calls)
    return traced_share(run, (KERNEL,), bound, {KERNEL: n})
