"""Model (models/): the mean engine-clock duration of a decode window
(``decode.window`` spans; each spans the row's decode steps over every
slot), in milliseconds.  Needs the traced run's spans."""


def read(ctx):
    d = [dur for n, dur in ctx["spans"] if n == "decode.window"]
    return 1e3 * sum(d) / len(d) if d else None
