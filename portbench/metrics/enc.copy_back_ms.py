"""The compacted stream's copies to host memory in the encode
(``gpujpeg.enc.copy_back``, a span a chunk inside
``gpujpeg.enc.memory_from``: the wait for the chunk's gather on the card
and its pageable copy), over every call of the encode phase, ms a frame
(program spans). None where the program records no such span."""
from portbench.spans import phase_spans

SPAN = "gpujpeg.enc.copy_back"


def read(run):
    got = phase_spans(run, "encode")
    if got is None:
        return None
    s, names, inside, roots = got
    sel = inside & (names == SPAN)
    if not sel.any():
        return None
    dur = (s["end_ns"][sel] - s["start_ns"][sel]).sum()
    return float(dur) * 1e-6 / int(roots.sum())
