"""The fused BWO generation: ``ops.bwo_evolve`` (sampling + update),
``ref`` (the plain version) and ``bwo_evolve`` (the CUDA kernel's build,
binding and launch count)."""
