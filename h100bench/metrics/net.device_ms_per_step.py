"""Device ms per train step of the net's library kernels (cuDNN's
convolutions, cuBLAS's and CUTLASS's GEMMs) in the profiled stretch."""

NET_KERNELS = r"(?i)conv|cudnn|gemm|xmma|cutlass|wgrad|dgrad|sm90_|implicit"


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    s = ctx.trace.device_s_matching(NET_KERNELS)
    return 1e3 * s / ctx.steps if s else None
