"""Launches of the Roaring kernels (``kernels.roaring.kernel``'s
``launch_counts``) in the window, a request."""


def read(run):
    if not run.launches or not run.counted_requests:
        return None
    return sum(run.launches.values()) / run.counted_requests
