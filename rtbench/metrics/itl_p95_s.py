"""95th percentile of the gaps between successive output tokens of every
request of the window, on the engine clock (seconds)."""

import numpy as np


def read(ctx):
    v = [g for r in ctx["done"] for g in np.diff(r["token_times"])]
    return float(np.percentile(v, 95)) if v else None
