"""Mean response time, arrival to last token, of every request of the
window, on the engine clock (seconds): the paper's headline metric."""

import numpy as np


def read(ctx):
    v = [r["finish"] - r["arrival"] for r in ctx["done"]]
    return float(np.mean(v)) if v else None
