"""Seconds of ``BitmapStore.build`` (host build and copy to the card,
synchronised) in set-up."""


def read(run):
    return run.setup.get("build") if run.system == "store" else None
