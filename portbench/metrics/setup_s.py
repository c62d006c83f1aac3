"""Seconds from the process's start to the window's first call: imports,
the card's context, the kernels' build or load, the frames, the coders
and the warm-up calls; not the reference's streams of the decode phase,
which only the judge's side of the run needs."""


def read(run):
    return run.setup_s
