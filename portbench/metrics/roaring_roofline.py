"""The least time the window's work needs, over all device time in it.

The work is counted from the benchmark's own inputs: each bitmap a
request's plain evaluation must read, once, at Roaring's sizes, and each
request's result (``yardstick.roaring_bytes``), read at the card's
published HBM rate. The device time is every kernel, copy and set of the
window (``yardstick.trace``), so moving work between a library operation
and a hand-written kernel cannot change the share.
"""

from portbench.yardstick.peaks import peak


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or run.window_bytes is None:
        return None
    try:
        rate = peak(run.device["kind"], "hbm_bytes_per_s")
    except KeyError:
        return None
    nbytes = run.window_bytes()
    if not nbytes:
        return None
    return 100.0 * nbytes / rate / run.trace.busy_s
