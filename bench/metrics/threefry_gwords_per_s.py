"""threefry_gwords_per_s (Gword/s): the 32-bit counters the traced rounds'
``threefry`` spans hashed, over those spans' seconds, in 10^9 a second
(``bench/spans.py``)."""
from bench import spans


def read(ctx):
    s = spans.traced(ctx)
    t = (s or {}).get("threefry")
    if not t or t["s"] <= 0 or t["count"] <= 0:
        return None
    return t["count"] / t["s"] / 1e9
