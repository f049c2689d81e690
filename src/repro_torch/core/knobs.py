# A copy of repro/core/knobs.py (pure Python), kept here so the port imports
# nothing of the JAX package.
"""Single source of truth for the round-engine knob vocabulary.

``Server`` (engine selection), the batched engine (client-axis
traversal), the CLI driver (``repro.launch.fl_train``), and the
:class:`repro.core.api.FLConfig` facade all validate their ``engine`` /
``vectorize`` strings through these helpers instead of keeping separate
choices lists.

``vectorize`` accepts an optional ``:k`` suffix (``"scan:4"``) setting
the ``lax.scan`` unroll chunk: the scan body is replicated ``k`` times
per loop iteration, so compile time stays O(model) while dispatch
overhead amortizes over ``k`` clients — the middle ground between
``scan`` (k=1) and ``unroll`` (k=n).  Only meaningful for ``scan`` and
for ``auto`` when it resolves to scan.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

ENGINES = ("auto", "batched", "sequential")
VECTORIZE_MODES = ("auto", "vmap", "scan", "unroll")

# Measured default for rounds_per_dispatch="auto" on the batched engine
# (DESIGN.md §6): enough rounds to amortize the per-dispatch host
# round-trip without block-sized compile blowup or coarse stopping.
DEFAULT_ROUNDS_PER_DISPATCH = 5

# pipeline_blocks knob vocabulary (DESIGN.md §7): double-buffer fused
# block dispatches against host-side log processing.
PIPELINE_MODES = ("auto", "on", "off")

# How many blocks may be in flight under the pipelined driver: 2 is
# classic double buffering — one executing on device while the previous
# block's logs are processed on host.  Deeper queues only grow the
# stopping-condition overshoot (one *in-flight* block per slot beyond
# the first) without hiding more latency.
DEFAULT_PIPELINE_DEPTH = 2


def parse_pipeline_blocks(spec: Union[bool, str, None]) -> Optional[bool]:
    """``"auto"``/``None`` -> ``None`` (the server resolves it: pipeline
    exactly when there is a fused batched block to overlap, i.e. the
    batched engine with ``rounds_per_dispatch > 1``); ``"on"``/``True``
    -> ``True`` (forced — still requires the batched engine);
    ``"off"``/``False`` -> ``False``."""
    if spec is None or spec == "auto":
        return None
    if isinstance(spec, bool):
        return spec
    low = str(spec).lower()
    if low in ("on", "true", "1"):
        return True
    if low in ("off", "false", "0"):
        return False
    raise ValueError(
        f"pipeline_blocks={spec!r} must be one of {PIPELINE_MODES} "
        f"(or a bool)")


def validate_pipeline_blocks(spec):
    parse_pipeline_blocks(spec)
    return spec


def parse_rounds_per_dispatch(spec: Union[int, str, None]) -> Optional[int]:
    """``"auto"``/``None`` -> ``None`` (the server resolves it against
    the engine policy: 1 when the round engine is sequential — e.g. conv
    tasks on CPU, DESIGN.md §4 — else the measured
    ``DEFAULT_ROUNDS_PER_DISPATCH``); anything else must be a positive
    integer round count."""
    if spec is None or spec == "auto":
        return None
    try:
        r = int(str(spec))     # rejects non-integral floats like 1.5
    except ValueError:
        raise ValueError(
            f"rounds_per_dispatch={spec!r} must be 'auto' or a positive "
            f"integer")
    if r < 1:
        raise ValueError(
            f"rounds_per_dispatch={spec!r} must be >= 1")
    return r


def validate_rounds_per_dispatch(spec):
    parse_rounds_per_dispatch(spec)
    return spec


# flcheck audit hook vocabulary (DESIGN.md §8): "off" skips the audit,
# "report" runs it and prints findings without gating, "strict" raises
# repro.analysis.AuditError on any error-severity finding.
AUDIT_MODES = ("off", "report", "strict")


def parse_audit(spec: Union[bool, str, None]) -> str:
    """``None``/``False``/``"off"`` -> ``"off"``; ``True`` ->
    ``"strict"`` (the boolean opt-in gates); else one of
    :data:`AUDIT_MODES`."""
    if spec is None:
        return "off"
    if isinstance(spec, bool):
        return "strict" if spec else "off"
    low = str(spec).lower()
    if low in AUDIT_MODES:
        return low
    raise ValueError(
        f"audit={spec!r} must be one of {AUDIT_MODES} (or a bool)")


def validate_audit(spec):
    parse_audit(spec)
    return spec


def validate_engine(name: str) -> str:
    if name not in ENGINES:
        raise ValueError(f"engine={name!r} not in {ENGINES}")
    return name


def parse_vectorize(spec: str) -> Tuple[str, int]:
    """``"scan:4"`` -> ``("scan", 4)``; bare modes get chunk 1."""
    base, sep, chunk = str(spec).partition(":")
    if base not in VECTORIZE_MODES:
        raise ValueError(
            f"vectorize={spec!r}: mode {base!r} not in {VECTORIZE_MODES}")
    if not sep:
        return base, 1
    if base not in ("scan", "auto"):
        raise ValueError(
            f"vectorize={spec!r}: the ':k' unroll chunk only applies to "
            f"'scan' (or 'auto' resolving to scan)")
    try:
        k = int(chunk)
    except ValueError:
        k = 0
    if k < 1:
        raise ValueError(
            f"vectorize={spec!r}: unroll chunk must be a positive integer")
    return base, k


def validate_vectorize(spec: str) -> str:
    parse_vectorize(spec)
    return spec
