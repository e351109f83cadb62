"""Milliseconds a pair in descriptor matching and the cluster gate: the
stage_times labels match_pyramid, match_corr (match_st, match_ts and corr on
the routes without the gate) (register_pair_staged's stage_times, each stage
synchronised)."""


def read(ctx):
    return ctx.stage_ms(lambda k: k.startswith("match") or k == "corr")
