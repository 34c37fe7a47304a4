"""The share of the traced device time spent in convolution kernels
(cuDNN's forward, data-gradient and weight-gradient kernels), in
percent of the time of all device operations."""

from benchmark import readers

LAYER = "Image step: models/resnet.py, train.py"
UNIT = "%"
MOVES = "images_per_s"
# cuDNN's convolution kernels on sm_90 (names read from a trace):
# sm90_xmma_{fprop,dgrad,wgrad}_*implicit_gemm*_cudnn, cutlass
# ImplicitGemmConvolution kernels built into cuDNN, its NHWC padding.
PATTERNS = ("cudnn", "fprop", "dgrad", "wgrad", "onvolution")


def read(reading):
    trace = getattr(reading, "trace", None)
    if trace is None:
        return None
    total = sum(end - start for _, start, end in trace.kernels)
    return readers.share_percent(trace.seconds(PATTERNS), total)
