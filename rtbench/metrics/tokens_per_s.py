"""Generated tokens of every request completed, over the window's wall
seconds (host clock, ``serve()`` to the ``synchronize()`` after it)."""


def read(ctx):
    n = sum(len(r["out_tokens"]) for r in ctx["done"])
    return n / ctx["wall_s"] if n else None
