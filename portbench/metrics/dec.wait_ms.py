"""The host's wait on the card in the decode (``gpujpeg.dec.wait``: the
sync after the kernels' enqueue), over every call of the decode phase,
ms a frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "decode", ("gpujpeg.dec.wait",))
