"""95th percentile of the latency of every request completed in the window,
submit to result on the client's clock, exact from the raw times."""

from portbench.yardstick.judge import percentile


def read(run):
    return percentile(run.latencies_s, 95) * 1e3 if run.latencies_s else None
