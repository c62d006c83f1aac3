"""The encode's compaction and copy back (``gpujpeg.enc.memory_from``:
the segments' gathers on the card, the chunked copies to the host and
the scan bodies' bytes), over every call of the encode phase, ms a
frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "encode", ("gpujpeg.enc.memory_from",))
