"""The destuffed segment rows' build on the host (``gpujpeg.dec.rows``:
``ops.decode.build_rows``), over every call of the decode phase, ms a
frame (program spans)."""
from portbench.spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "decode", ("gpujpeg.dec.rows",))
