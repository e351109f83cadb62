"""Device milliseconds a pair of the program's own kernels (the __global__
functions of its csrc/*.cu), from torch.profiler over the profiled pairs."""


def read(ctx):
    if not ctx.profiled_pairs or not ctx.device_ops:
        return None
    s = sum(v for k, v in ctx.device_ops.items() if ctx.is_handwritten(k))
    return 1e3 * s / ctx.profiled_pairs
