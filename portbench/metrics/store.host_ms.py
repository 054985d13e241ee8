"""Host milliseconds a store call spends in the store's own code: the self
time of the program's ``store.*`` spans (``span.self_s``) over its root
spans (``span.roots``, one a ``count`` or ``sum_``). The spans record
under the traced part of the window only."""

import sys


def read(run):
    obs = sys.modules.get("repro_torch.obs")
    reg = obs.registry() if obs else None
    roots = reg.value("span.roots") if reg else 0
    if not roots:
        return None
    return 1e3 * sum(c.value for (name, labels), c in reg.counters()
                     if name == "span.self_s"
                     and dict(labels)["span"].startswith("store.")) / roots
