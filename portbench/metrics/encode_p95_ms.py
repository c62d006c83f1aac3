"""95th percentile of the latency of every encode call of the window, ms
(host clock)."""
from portbench.window import percentile_ms


def read(run):
    return percentile_ms(run.phases["encode"], 95)
