"""Model: the FLOPs the prompts of the requests served on the card's paged
path need (their tokens' forwards and the first token's logits;
counting.request_work) over the seconds of the fused prefill dispatches
(``prefill.ragged`` spans), as a share of the H100's 989 TFLOP/s (%).
Needs the traced run's spans."""


def read(ctx):
    s = sum(d for n, d in ctx["spans"] if n == "prefill.ragged")
    if not s:
        return None
    return 100.0 * ctx["work"]["prompt_flops"] / s / ctx["peak_flops"]
