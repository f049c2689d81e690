"""The threefry2x32 draws: ``ops`` (the ``repro_torch::threefry`` operator
and its vmap rule), ``ref`` (the plain version: ``random.py``'s int64 route)
and ``threefry`` (the CUDA kernel's build, binding and launch count)."""
