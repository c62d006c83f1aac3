"""Share of the traced decode phase's span in which the card runs no
kernel, copy or set (profiler timeline), in %."""


def read(run):
    t = run.traces.get("decode")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
