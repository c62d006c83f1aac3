"""The least time the card needs for the traced encode calls' work
(``bounds.frame_bound``: the raw frame read once and the stream written
once, or the DCT's float32 operations) over the summed device time of
every kernel the traced encode phase launched, in %."""
from portbench.bounds import frame_bound


def read(run):
    t = run.traces.get("encode")
    if not t or t["kernel_s"] <= 0:
        return None
    b, _ = frame_bound(run.cfg, run.geo, run.stream_bytes["encode"],
                       "encode")
    return 100.0 * t["calls"] * b / t["kernel_s"]
