"""Device ms a step in NCCL's kernels (the sync-BatchNorm moments and
the gradient all-reduce) on rank 0, over the traced steps."""

LAYER = ("Parallel: parallel/collectives.py, models/resnet.py sync "
         "BatchNorm, models/train.py reduce_gradients")
UNIT = "ms"
MOVES = "images_per_s"
PATTERNS = ("nccl",)


def read(reading):
    trace = getattr(reading, "trace", None)
    if trace is None or not reading.counts.get("traced_steps"):
        return None
    seconds = trace.seconds(PATTERNS)
    if seconds <= 0:
        return None
    return 1000.0 * seconds / reading.counts["traced_steps"]
