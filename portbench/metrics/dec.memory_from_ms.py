"""The decoded frame's copy to host memory
(``Decoder.stats.duration_memory_from``), over the phase's calls, ms a
frame. A decode to the card has no such copy and records nothing: the
reader returns nothing there."""


def read(run):
    if run.traffic["output"] != "host":
        return None
    st = [s["memory_from_ms"] for s in run.phases["decode"].stats if s]
    return sum(st) / len(st) if st else None
