"""Milliseconds a pair in grids and ISS keypoints: the stage_times labels
fs_maps, plan, side_src / side_tgt and bucket (register_pair_staged's
stage_times, each stage synchronised)."""


def read(ctx):
    return ctx.stage_ms(lambda k: k in ("fs_maps", "plan", "side_src", "side_tgt", "bucket"))
