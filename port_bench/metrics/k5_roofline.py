"""K5's roofline share in the traced window: the least time the admits
it ran there could take in K5 (one call a layer; ``harness/work.py``'s
copy of ``flash_attention_work`` at the H100's peaks) over the device time
of K5's kernels (``flash_tc_kernel``, ``flash_kernel``), in %."""
from harness import work

KERNELS = ("flash_tc_kernel", "flash_kernel")


def read(run):
    t = run.trace
    if not t:
        return None
    k5_s = sum(s for name, s in t["device_s_by_op"].items()
               if any(k in name for k in KERNELS))
    lo, hi = run.window.traced
    bound = sum(work.k5_bound_s(run.config, r.prompt_len)
                for r in run.window.reqs
                if r.tokens_t and lo <= r.admit_start and r.admit_end <= hi)
    if not k5_s or not bound:
        return None
    return 100.0 * bound * run.config["num_hidden_layers"] / k5_s
