"""The stream's parse (``Decoder.stats.duration_stream``: markers, tables,
segment split), over the phase's calls, ms a frame."""


def read(run):
    st = [s["stream_ms"] for s in run.phases["decode"].stats if s]
    return sum(st) / len(st) if st else None
