"""Milliseconds a pair in surface normals and descriptors: the stage_times
labels fpfh_* and shot_* (per pyramid level _l<level>)
(register_pair_staged's stage_times, each stage synchronised)."""


def read(ctx):
    return ctx.stage_ms(lambda k: k.startswith(("fpfh_", "shot_")))
