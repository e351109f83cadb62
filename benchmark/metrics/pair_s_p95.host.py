"""The 95th percentile (nearest rank) of the seconds a pair in the traced
run's stage-timed pairs, on the host's clock: the tail where the card idles
most of the window and the host holds it back."""
import math


def read(ctx):
    if not ctx.pair_s:
        return None
    v = sorted(ctx.pair_s)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]
