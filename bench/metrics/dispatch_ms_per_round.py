"""dispatch_ms_per_round (ms): the host's time enqueueing the window's
blocks, ``CommMeter.timing_summary()["dispatch_s"]`` over the window's
blocks alone, per round."""


def read(ctx):
    w = ctx.window
    if not w["rounds"]:
        return None
    return 1000.0 * w["timing"]["dispatch_s"] / w["rounds"]
