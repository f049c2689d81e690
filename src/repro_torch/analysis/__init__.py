"""flcheck in the port: a static program auditor for the FL round engine.

Machine-checks the invariants the engine's performance story depends on
(DESIGN.md §8): one device->host sync per fused block, buffer reuse of the
captured block, no float64 in round programs, outputs of their declared
dtypes, no host reads inside the fused loop, the conv-on-CPU engine
policy, and one capture per block shape with participant-independent
shards -- over (a) the ops each engine-built program dispatches, (b) on
the card, the captured block's CUDA graph, and (c) the Python AST of
``src/repro_torch``.

    python -m repro_torch.analysis.cli --device cpu --task mlp \\
        --strategy fedbwo --strict

NOTE: this module is imported *by* ``repro_torch.core.engine`` (the op
recorder drives its conv auto policy), so only the dependency-free pieces
(walker, report) are imported eagerly; the audit/rules layers -- which
import ``repro_torch.core`` back -- load lazily on first attribute access.
"""
from repro_torch.analysis.report import (AuditError, Finding, Report,
                                         SEVERITIES)
from repro_torch.analysis.walker import (CONV_OPS, HOST_READ_OPS, OpSite,
                                         count_ops, has_op, iter_dtypes,
                                         iter_sites, loss_uses_conv,
                                         record_ops)

_LAZY = {
    "RULES": "repro_torch.analysis.rules",
    "rule": "repro_torch.analysis.rules",
    "run_rules": "repro_torch.analysis.rules",
    "AuditContext": "repro_torch.analysis.audit",
    "ProgramSubject": "repro_torch.analysis.audit",
    "audit_experiment": "repro_torch.analysis.audit",
    "collect_subjects": "repro_torch.analysis.audit",
    "lint_paths": "repro_torch.analysis.pylint_torch",
    "lint_source": "repro_torch.analysis.pylint_torch",
}

__all__ = ["AuditError", "Finding", "Report", "SEVERITIES", "CONV_OPS",
           "HOST_READ_OPS", "OpSite", "count_ops", "has_op", "iter_dtypes",
           "iter_sites", "loss_uses_conv", "record_ops", *_LAZY]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
