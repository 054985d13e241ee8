"""Times a store call's host blocks on the card: the program's
``device.wait`` spans (``span.n``) over its root spans (``span.roots``,
one a ``count`` or ``sum_``). The spans record under the traced part of
the window only."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    reg = obs.registry() if obs else None
    roots = reg.value("span.roots") if reg else 0
    if not roots:
        return None
    return reg.value("span.n", span="device.wait") / roots
