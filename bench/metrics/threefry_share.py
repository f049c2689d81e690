"""threefry_share (%): the traced rounds' ``threefry`` device spans (every
sized draw through ``random.fill``: the counters' hash and the sampler's
map of them) over their ``round`` spans, from the port's span log
(``bench/spans.py``).  Key splits and ``randint``'s and ``bernoulli``'s
arithmetic around a draw are not in it."""
from bench import spans


def read(ctx):
    s = spans.traced(ctx)
    if not s or "threefry" not in s or not s.get("round", {}).get("s"):
        return None
    return 100.0 * s["threefry"]["s"] / s["round"]["s"]
