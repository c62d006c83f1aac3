"""The least time for the entropy stage's work (``gpujpeg_tpu_torch``'s
E2 ``huffman_blocks`` and E3 ``merge_stuff``: every block's 64
coefficients read once at 2 B each and the stream's bytes written once)
over the summed device time of those kernels in the traced encode phase,
in % (device trace). None where the phase launched neither."""
from portbench.bounds import bound

#: the entropy stage's kernels' names hold one of these
KERNELS = ("huffman_blocks", "merge_stuff")
#: bytes a coefficient of the stage's input counts (the 16-bit range of a
#: baseline coefficient, however the program stores it)
COEFF_BYTES = 2


def entropy_bound(stream_bytes: float, n_blocks: int) -> float:
    """Seconds: a frame's entropy stage at the card's memory rate."""
    return bound(n_blocks * 64 * COEFF_BYTES + stream_bytes, 0.0)[0]


def read(run):
    t = run.traces.get("encode")
    if not t:
        return None
    s = sum(v for k, v in t["ops"].items()
            if any(n in k for n in KERNELS))
    if s <= 0:
        return None
    return 100.0 * t["calls"] * entropy_bound(run.stream_bytes["encode"],
                                              run.geo.n_blocks) / s
