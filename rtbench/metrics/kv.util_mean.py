"""KV cache (kvcache/): the mean share of the page pool's blocks in use,
sampled after each decode window (``_result["kv_util_mean"]``, %)."""


def read(ctx):
    return 100.0 * ctx["result"]["kv_util_mean"]
