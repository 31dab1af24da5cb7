"""The share of the traced window in which no operation ran on the
card (1 - the union of the device's intervals over the window), in %,
in a training cell."""

from perfbench.lib import profile


def read(ctx):
    return profile.idle_share(ctx["trace"])
