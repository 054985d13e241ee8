"""Host seconds of ``BitmapStore.build`` before the copy to the card: the
program's ``store.build_s`` counters of the sorts and host bitmaps
(``phase=postings``) and of packing them into the slab's arrays
(``phase=pack``). Read in a traced run, when the program's spans
recorded (``span.roots``)."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    reg = obs.registry() if obs else None
    if not reg or not reg.value("span.roots"):
        return None
    return (reg.value("store.build_s", phase="postings")
            + reg.value("store.build_s", phase="pack"))
