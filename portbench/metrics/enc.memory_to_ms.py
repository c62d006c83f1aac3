"""The raw frame's upload (``Encoder.stats.duration_memory_to`` with
``Parameters.perf_stats``: CUDA events around the copy), over the phase's
calls, ms a frame; near 0 where the frame is on the card already."""


def read(run):
    st = [s["memory_to_ms"] for s in run.phases["encode"].stats if s]
    return sum(st) / len(st) if st else None
