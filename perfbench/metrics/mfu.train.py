"""The training step's model FLOPs (6 a matmul parameter and token, the
causal attention three times, no recompute) of the steps in the traced
window, over the window times the card's bf16 peak, in %."""

from perfbench.lib import peaks


def read(ctx):
    c = ctx["counts"]
    if not c.get("steps"):
        return None
    flops = c["steps"] * peaks.train_flops_per_step(ctx["arch"], c["rows"],
                                                    c["seq"])
    return 100.0 * flops / (ctx["trace"]["window_s"] * peaks.PEAK_BF16)
