"""Device milliseconds a pair of every other device operation (PyTorch's,
cuBLAS's and CUB's kernels, copies and fills), from torch.profiler over the
profiled pairs."""


def read(ctx):
    if not ctx.profiled_pairs or not ctx.device_ops:
        return None
    s = sum(v for k, v in ctx.device_ops.items() if not ctx.is_handwritten(k))
    return 1e3 * s / ctx.profiled_pairs
