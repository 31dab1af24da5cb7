"""The flash-attention forward's share of its roofline: the least time
of one call at the cell's shapes (``peaks.flash_bound_s`` of a step's
rows, the configuration's heads, causal) times the launches, over the
device time of the launches of kernels named ``flash_fwd``.  Nothing
when no such kernel ran (a renamed kernel needs a new reader)."""

from perfbench.lib import peaks, profile


def read(ctx):
    secs, n = profile.kernel_time(ctx["trace"], lambda k: "flash_fwd" in k)
    if not n or secs <= 0:
        return None
    a, tr = ctx["arch"], ctx["traffic"]
    hd = a.get("head_dim") or a["d_model"] // a["num_heads"]
    bound = peaks.flash_bound_s(tr["rows"], a["num_heads"],
                                a["num_kv_heads"], tr["seq"], hd, a["dtype"])
    return 100.0 * bound * n / secs
