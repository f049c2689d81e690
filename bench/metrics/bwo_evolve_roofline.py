"""bwo_evolve_roofline (%): the launch's bytes bound (``bench/counts.py``,
at the mix's rows and D, over the card's HBM bandwidth) over the mean
device time of the ``bwo_evolve`` kernel, found by name in the trace.
Nothing when the trace holds no such kernel."""
from bench import counts


def read(ctx):
    t = ctx.trace
    if t is None or ctx.traffic["strategy"] != "fedbwo":
        return None
    hits = [v for name, v in t.kernels.items() if "bwo_evolve" in name]
    n = sum(c for c, _ in hits)
    if n == 0:
        return None
    mean_s = sum(s for _, s in hits) / n
    least_s = counts.bwo_launch_bytes(ctx.cfg, ctx.traffic) / \
        counts.PEAKS["hbm_bytes_per_s"]
    return 100.0 * least_s / mean_s
