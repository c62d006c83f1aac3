"""The host's wait on the card in the encode (``gpujpeg.enc.wait``: the
segment lengths' copy back, which waits for E3), over every call of
the encode phase, ms a frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "encode", ("gpujpeg.enc.wait",))
