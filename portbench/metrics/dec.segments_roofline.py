"""The least time for the segment stage's work (``gpujpeg_tpu_torch``'s
D0 ``destuff_rows`` and D1 ``huffman_decode``, the Huffman decode of
streams with restart markers: the stream's bytes read once and every
block's 64 coefficients written once at 2 B each) over the summed device
time of those kernels in the traced decode phase, in % (device trace).
None where the phase launched neither."""
from portbench.bounds import bound

#: the segment stage's kernels' names hold one of these
KERNELS = ("destuff_rows", "huffman_decode")
#: bytes a coefficient of the stage's output counts (the 16-bit range of a
#: baseline coefficient, however the program stores it)
COEFF_BYTES = 2


def segments_bound(stream_bytes: float, n_blocks: int) -> float:
    """Seconds: a frame's segment stage at the card's memory rate."""
    return bound(stream_bytes + n_blocks * 64 * COEFF_BYTES, 0.0)[0]


def read(run):
    t = run.traces.get("decode")
    if not t:
        return None
    s = sum(v for k, v in t["ops"].items()
            if any(n in k for n in KERNELS))
    if s <= 0:
        return None
    return 100.0 * t["calls"] * segments_bound(run.stream_bytes["decode"],
                                               run.geo.n_blocks) / s
