"""warmup_capture_s (s): the harness's clock around the set-up block's
dispatch: the eager warm-up round (which ends in a sync), the capture of
the block's CUDA graph, and the replay's enqueue."""


def read(ctx):
    return ctx.setup.get("warmup_capture_s")
