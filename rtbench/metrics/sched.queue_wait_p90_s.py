"""Policy and admission (core/scheduler.py, core/predictor.py): the
engine's 90th percentile of queue wait, admission time less arrival, on
the engine clock (``_result["queue_wait_p90"]``, seconds)."""


def read(ctx):
    return ctx["result"].get("queue_wait_p90")
