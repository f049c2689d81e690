"""device_idle_share (%): the share of the traced span in which no
kernel, copy or fill ran on the card, from ``torch.profiler``'s CUDA
activity (overlapping ones counted once), over the span on the device's
clock: the traced blocks on a full pipeline, each with the gap before it
(``bench/tracing.py``)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
