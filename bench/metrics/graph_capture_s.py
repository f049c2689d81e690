"""graph_capture_s (s): the set-up's ``capture`` host spans, the capture
of each block shape's CUDA graph, summed (``bench/spans.py``)."""
from bench import spans


def read(ctx):
    return spans.setup_seconds("capture")
