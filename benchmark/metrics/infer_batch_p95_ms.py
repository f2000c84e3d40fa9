"""The 95th percentile of every call of the (plain) window, from the call to
the synchronise that makes its outputs available, in ms."""

import numpy as np


def read(run):
    if not run["latencies"]:
        return None
    return 1e3 * float(np.percentile(np.asarray(run["latencies"], dtype=np.float64), 95))
