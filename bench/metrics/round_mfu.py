"""round_mfu (%): a round's model FLOPs (``bench/counts.py``: 3 forward
passes a trained sample, 1 a fitness and an evaluation sample) over the
traced stretch's seconds a round times the card's float32 peak."""
from bench import counts


def read(ctx):
    t = ctx.trace
    if t is None or t.rounds <= 0 or t.window_s <= 0:
        return None
    flops = counts.rounds_flops(ctx.cfg, ctx.traffic, ctx.traced_from,
                                t.rounds)
    return 100.0 * flops / (t.window_s * counts.PEAKS["float32_flop_per_s"])
