"""The segment rows' upload to the card (``gpujpeg.dec.memory_to``: the
pageable copy of the rows), over every call of the decode phase, ms a
frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "decode", ("gpujpeg.dec.memory_to",))
