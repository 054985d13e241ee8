"""The card's allocator peak over set-up and window, in GiB."""


def read(run):
    peak = run.device.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
