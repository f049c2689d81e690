"""The selective-SSM scan: ``ops.ssm_scan`` (the public entry), ``ref``
(the plain version) and ``ssm_scan`` (the CUDA kernel's build, binding and
launch count)."""
