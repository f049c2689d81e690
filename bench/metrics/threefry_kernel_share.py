"""threefry_kernel_share (%): of the counters the traced rounds'
``threefry`` spans drew, the share that ``threefry_kernel`` spans (one
launch of the port's threefry kernel, inside a draw's ``threefry`` span)
hashed, from the port's span log (``bench/spans.py``).  100 when every
sized draw goes through the kernel; None on a port without that span."""
from bench import spans


def read(ctx):
    s = spans.traced(ctx)
    if not s or "threefry_kernel" not in s:
        return None
    drawn = s.get("threefry", {}).get("count", 0)
    if drawn <= 0:
        return None
    return 100.0 * s["threefry_kernel"]["count"] / drawn
