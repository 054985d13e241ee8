"""Requests completed in the window over the window's seconds."""


def read(run):
    return run.n_done / run.window_s if run.window_s > 0 else None
