"""warmup_round_s (s): the set-up's ``warmup`` host span, the round
engine's eager warm-up round through its sync (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.setup_seconds("warmup")
