"""Median time to first token over every request of the window, from the
time it was due, on the engine clock (seconds)."""

import numpy as np


def read(ctx):
    v = [r["token_times"][0] - r["arrival"] for r in ctx["done"]
         if r["token_times"]]
    return float(np.median(v)) if v else None
