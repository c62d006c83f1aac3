"""95th percentile of the latency of every decode call of the window, ms
(host clock)."""
from portbench.window import percentile_ms


def read(run):
    return percentile_ms(run.phases["decode"], 95)
