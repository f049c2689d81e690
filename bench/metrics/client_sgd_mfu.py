"""client_sgd_mfu (%): the traced rounds' trained FLOPs
(``bench/counts.py``: 3 forward passes a trained sample) over the self
seconds of their ``sgd`` device spans (the dropout draws' ``threefry``
spans inside taken out) times the card's float32 peak
(``bench/spans.py``)."""
from bench import counts, spans


def read(ctx):
    s = spans.traced(ctx)
    t = (s or {}).get("sgd")
    if not t or t["self_s"] <= 0:
        return None
    flops = 3 * counts.round_samples(ctx.traffic)["trained"] * \
        counts.forward_flops(ctx.cfg) * ctx.trace.rounds
    return 100.0 * flops / (t["self_s"] * counts.PEAKS["float32_flop_per_s"])
