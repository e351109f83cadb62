"""Milliseconds a pair in the pre-downsample (flagship.pre_downsample_pair), on
the benchmark's clock with a synchronise on each side."""


def read(ctx):
    if not ctx.stage_pairs:
        return None
    return 1e3 * ctx.pre_downsample_s / ctx.stage_pairs
