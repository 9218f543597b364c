"""Executables (serving/generate.py): seconds the window's serve spent
capturing CUDA graphs, at its start and at each shape key first met
(``graph_stats()["capture_s"]``)."""


def read(ctx):
    return ctx["graph_stats"].get("capture_s")
