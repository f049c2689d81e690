"""Flash attention: ``ops.flash_attention`` (the public entry), ``ref``
(the plain version) and ``flash_attention`` (the CUDA kernel's build,
binding and launch count)."""
