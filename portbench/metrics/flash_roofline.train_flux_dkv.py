"""The head-dim-128 flash dK/dV kernel's share of its roofline over FLUX's
traced training steps, in %: the least time of the joint attention calls
(512 text + 4,096 image tokens at 1,024px, one a block) over the device
time of flash_bwd_dkv_kernel's d = 128 instance. A kernel's least time is
its own work, as PERF.md section 6 prices the three: 4 units (S again,
dV, dP^T, dK), `flash_bound_s(call, True)`. Silent unless the instance's
traced launches, and the program's `dkv` head-dim-128 counter over the
traced steps, equal the calls."""

from portbench.flops import flash_bound_s, traced_share
from portbench.flops_flux import joint_calls

KERNEL = "flash_bwd_dkv_kernel<128"
SHARE = 1.0
BACKWARD = True


def read(run):
    t, w = run.traffic, run.window
    passes = w["traced_steps"] * t["batch_size"] // t["microbatch"]
    calls = joint_calls(run.config["transformer"], t["microbatch"],
                        t["latent_side"], t["caption_tokens"])
    if not passes or not calls:
        return None
    n = passes * len(calls)
    if (w.get("d128_launches") or {}).get("dkv") != n:
        return None
    bound = passes * sum(SHARE * flash_bound_s(c, BACKWARD) for c in calls)
    return traced_share(run, (KERNEL,), bound, {KERNEL: n})
