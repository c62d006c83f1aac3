"""The least time for the lane stage's work (``gpujpeg_tpu_torch``'s
``huffman_lanes``, the Huffman decode of scans without restart markers:
the scan's bytes read once and every block's 64 coefficients written once
at 2 B each) over the summed device time of the lane kernels in the traced
decode phase, in % (device trace). None where the phase launched no lane
kernel."""
from portbench.bounds import bound

#: the lane kernels' names hold this
KERNEL = "huffman_lanes"
#: bytes a coefficient of the stage's output counts (the 16-bit range of a
#: baseline coefficient, however the program stores it)
COEFF_BYTES = 2


def lane_bound(stream_bytes: float, n_blocks: int) -> float:
    """Seconds: a frame's lane stage at the card's memory rate."""
    return bound(stream_bytes + n_blocks * 64 * COEFF_BYTES, 0.0)[0]


def read(run):
    t = run.traces.get("decode")
    if not t:
        return None
    s = sum(v for k, v in t["ops"].items() if KERNEL in k)
    if s <= 0:
        return None
    return 100.0 * t["calls"] * lane_bound(run.stream_bytes["decode"],
                                           run.geo.n_blocks) / s
