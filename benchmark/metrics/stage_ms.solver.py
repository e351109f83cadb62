"""Milliseconds a pair in the solver: the stage_times labels ransac and gror
(register_pair_staged's stage_times, each stage synchronised)."""


def read(ctx):
    return ctx.stage_ms(lambda k: k in ("ransac", "gror"))
