"""The least time the card needs for the traced decode calls' work (the
stream read once and the frame written once, or the IDCT's float32
operations) over the summed device time of every kernel the traced
decode phase launched, in %."""
from portbench.bounds import frame_bound


def read(run):
    t = run.traces.get("decode")
    if not t or t["kernel_s"] <= 0:
        return None
    b, _ = frame_bound(run.cfg, run.geo, run.stream_bytes["decode"],
                       "decode")
    return 100.0 * t["calls"] * b / t["kernel_s"]
