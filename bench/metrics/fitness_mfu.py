"""fitness_mfu (%): the traced rounds' fitness FLOPs (``bench/counts.py``:
one forward pass a fitness sample) over the seconds of their ``fitness``
device spans (every call of the client's fitness function) times the
card's float32 peak (``bench/spans.py``)."""
from bench import counts, spans


def read(ctx):
    s = spans.traced(ctx)
    t = (s or {}).get("fitness")
    if not t or t["s"] <= 0:
        return None
    flops = counts.round_samples(ctx.traffic)["fitness"] * \
        counts.forward_flops(ctx.cfg) * ctx.trace.rounds
    return 100.0 * flops / (t["s"] * counts.PEAKS["float32_flop_per_s"])
