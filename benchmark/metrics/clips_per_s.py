"""clips_per_s: clips of every request completed in the window (output on
the host) over the window's seconds."""


def read(run):
    return sum(r.clips for r in run.records) / run.window_s
