"""Device time of the loss's convolution kernels (SSIM's blur, forward and
backward) per traced step, in ms."""

PATTERNS = ("cudnn", "conv2d", "xmma", "implicit_gemm", "wgrad", "dgrad")


def read(run):
    t = run.trace
    if t is None or run.unit != "step" or not t.units:
        return None
    s = t.kernel_s(*PATTERNS)
    return s * 1e3 / t.units if s > 0 else None
