"""Stream assembly of the encode (``Encoder.stats.duration_stream``: the
JPEG writer over the scan bodies), summed over the phase's calls and
divided by their count, ms a frame."""


def read(run):
    st = [s["stream_ms"] for s in run.phases["encode"].stats if s]
    return sum(st) / len(st) if st else None
