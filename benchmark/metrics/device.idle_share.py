"""Per cent of the profiled stretch in which no operation ran on the device: 1
- (union of the device operations' intervals) / the stretch."""


def read(ctx):
    if ctx.window_s <= 0 or not ctx.device_ops:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
