"""AST lint pass over ``src/repro_torch``: host-sync and capture hazards.

The port's counterpart of ``repro.analysis.pylint_jax``, with the same
three checks (DESIGN.md §8):

``host-conversion-in-jit`` (error)
    ``float(x)`` / ``int(x)`` / ``bool(x)`` on a value that is not shape
    metadata, ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()``,
    or ``np.asarray(x)`` inside a function the port runs transformed or
    captured: one passed to ``torch.func.vmap`` / ``grad`` /
    ``grad_and_value`` / ``vjp`` / ``jacrev`` / ``functional_call`` or
    registered with ``torch.library`` (as an argument or a decorator), one
    called inside a ``with torch.cuda.graph(...)`` block, the engine's
    block and round functions (``block_fn``, ``round_fn``), and any
    function defined lexically inside one of them.  A host conversion
    there fails under vmap, fails a CUDA graph capture, or forces a
    device->host sync per call.

``paired-host-conversions`` (warning)
    ``float(a), float(b)`` tuples on plain names in host code whose
    enclosing function never copies to the host in one go (``.cpu()``,
    ``.numpy()``, ``.tolist()``, ``torch.cuda.synchronize``, the server's
    ``_fetch``): each conversion blocks on the device separately, so N
    conversions pay N syncs where one copy would pay one.

``mutable-default-arg`` (warning)
    Tensor-valued (``torch.zeros(...)``-style) or mutable-literal
    defaults: evaluated once at import and shared across calls.

Lines carrying a ``# flcheck: ok`` comment are exempt from all checks.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.report import Finding

# callee basename -> positional indices holding traced callables
_TRACED_ARG_POS: Dict[str, Iterable[int]] = {
    "vmap": (0,), "grad": (0,), "grad_and_value": (0,), "vjp": (0,),
    "jacrev": (0,), "functional_call": (0,),
}
# torch.library registrations: every callable argument (by name) is the
# op's implementation, fake, vmap rule or autograd formula
_REGISTRATIONS = ("custom_op", "register_fake", "register_vmap",
                  "register_autograd", "register_kernel", "impl")
_TRACED_DECORATORS = ("vmap", "grad", "grad_and_value") + _REGISTRATIONS
# the engine's block and round functions (core/engine.py)
_ENGINE_TRACED = ("block_fn", "round_fn")
_CONVERSIONS = ("float", "int", "bool")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")
_NP_ROOTS = ("np", "numpy", "onp")
_ARRAY_FACTORIES = ("zeros", "ones", "full", "empty", "array", "asarray",
                    "arange", "eye", "zeros_like", "ones_like", "linspace",
                    "tensor", "randn", "rand")
_SYNC_CALLS = ("cpu", "numpy", "tolist", "synchronize", "_fetch")
_ALLOW_COMMENT = "flcheck: ok"


def _basename(func: ast.expr) -> str:
    """Last attribute of a dotted callee: torch.func.vmap -> vmap."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _root_name(func: ast.expr) -> str:
    """Leftmost name of a dotted callee: np.asarray -> np."""
    while isinstance(func, ast.Attribute):
        func = func.value
    return func.id if isinstance(func, ast.Name) else ""


def _is_shape_like(node: ast.expr,
                   static_names: Set[str] = frozenset()) -> bool:
    """Conversions of static metadata (shapes, lens, dtypes, python
    constants, and names derived from them) are trace-safe — don't flag
    them."""
    if isinstance(node, ast.Constant):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "size", "dtype", "itemsize", "numel",
                "dim", "element_size"):
            return True
        if isinstance(sub, ast.Call) and _basename(sub.func) == "len":
            return True
        if isinstance(sub, ast.Name) and sub.id in static_names:
            return True
    return False


def _static_names(fn: ast.FunctionDef) -> Set[str]:
    """Names assigned from shape-like expressions inside ``fn`` (e.g.
    ``P, D = x.shape``; ``n = len(batches)``) — trace-static python
    ints, safe to convert."""
    static: Set[str] = set()
    for _ in range(2):                       # one propagation round
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not _is_shape_like(node.value, static):
                continue
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                static.update(e.id for e in elts
                              if isinstance(e, ast.Name))
    return static


def _allowed_lines(src: str) -> Set[int]:
    return {i for i, line in enumerate(src.splitlines(), start=1)
            if _ALLOW_COMMENT in line}


def _collect_traced_names(tree: ast.Module) -> Set[str]:
    """Names of functions passed (by name) to a torch.func transform or a
    torch.library registration, or called inside a ``with
    torch.cuda.graph(...)`` block, plus the engine's block and round
    functions."""
    traced: Set[str] = set(_ENGINE_TRACED)
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and _basename(item.context_expr.func) == "graph"
                and _root_name(item.context_expr.func) == "torch"
                for item in node.items):
            traced.update(sub.func.id for stmt in node.body
                          for sub in ast.walk(stmt)
                          if isinstance(sub, ast.Call)
                          and isinstance(sub.func, ast.Name))
        if not isinstance(node, ast.Call):
            continue
        base = _basename(node.func)
        if base in _REGISTRATIONS:
            traced.update(a.id for a in node.args if isinstance(a, ast.Name))
            continue
        positions = _TRACED_ARG_POS.get(base)
        if positions is None:
            continue
        for pos in positions:
            if pos < len(node.args) and isinstance(node.args[pos],
                                                   ast.Name):
                traced.add(node.args[pos].id)
    return traced


def _has_traced_decorator(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _basename(target) in _TRACED_DECORATORS:
            return True
        # functools.partial(torch.func.vmap, ...) shapes
        if isinstance(dec, ast.Call) and _basename(dec.func) == "partial" \
                and dec.args and _basename(dec.args[0]) \
                in _TRACED_DECORATORS:
            return True
    return False


def _conversion_call(node: ast.Call,
                     static_names: Set[str] = frozenset()) -> Optional[str]:
    """'float' / 'int' / 'bool' / '.item' / ... / 'np.asarray' when
    ``node`` is a host conversion of a dynamic value, else None."""
    base = _basename(node.func)
    if isinstance(node.func, ast.Attribute) and base in _HOST_METHODS \
            and not node.args and _root_name(node.func) not in _NP_ROOTS:
        return f".{base}"
    if isinstance(node.func, ast.Name) and base in _CONVERSIONS:
        if len(node.args) == 1 and not _is_shape_like(node.args[0],
                                                      static_names):
            return base
    if base in ("asarray", "array") and _root_name(node.func) in _NP_ROOTS:
        if node.args and not _is_shape_like(node.args[0], static_names):
            return f"{_root_name(node.func)}.{base}"
    return None


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Run all AST checks over one module's source."""
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Finding("pylint-torch", "warning",
                        f"could not parse: {e}", subject=filename)]
    allowed = _allowed_lines(src)
    traced_names = _collect_traced_names(tree)
    findings: List[Finding] = []

    def loc(node) -> str:
        return f"{filename}:{getattr(node, 'lineno', 0)}"

    def visit_fn(fn: ast.FunctionDef, inside_traced: bool):
        is_traced = (inside_traced or fn.name in traced_names
                     or _has_traced_decorator(fn))
        statics = _static_names(fn)
        calls_sync = any(
            isinstance(n, ast.Call) and _basename(n.func) in _SYNC_CALLS
            for n in ast.walk(fn))
        nested = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                nested.append(node)
        nested_set = set()
        for n in nested:
            nested_set.update(ast.walk(n))

        for node in ast.walk(fn):
            if node in nested_set and isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if is_traced and isinstance(node, ast.Call) \
                    and node not in nested_set \
                    and node.lineno not in allowed:
                conv = _conversion_call(node, statics)
                if conv:
                    findings.append(Finding(
                        "host-conversion-in-jit", "error",
                        f"{conv}() on a device value inside traced "
                        f"function {fn.name!r} — fails under vmap or a "
                        f"graph capture, or forces a per-call host sync",
                        subject=filename, location=loc(node)))
            if not is_traced and not calls_sync \
                    and isinstance(node, ast.Tuple) \
                    and node not in nested_set \
                    and getattr(node, "lineno", 0) not in allowed:
                convs = [e for e in node.elts
                         if isinstance(e, ast.Call)
                         and isinstance(e.func, ast.Name)
                         and e.func.id == "float"
                         and len(e.args) == 1
                         and isinstance(e.args[0], ast.Name)
                         and e.args[0].id not in statics]
                if len(convs) >= 2:
                    findings.append(Finding(
                        "paired-host-conversions", "warning",
                        f"{len(convs)} scalar conversions in one tuple "
                        f"in {fn.name!r} with no host copy in scope — "
                        f"each blocks on the device separately; batch "
                        f"them into one copy to the host",
                        subject=filename, location=loc(node)))
        # defaults (checked for every function)
        for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]:
            if getattr(default, "lineno", 0) in allowed:
                continue
            bad = isinstance(default, (ast.List, ast.Dict, ast.Set))
            if isinstance(default, ast.Call) \
                    and _basename(default.func) in _ARRAY_FACTORIES \
                    and _root_name(default.func) in _NP_ROOTS + ("torch",):
                bad = True
            if bad:
                findings.append(Finding(
                    "mutable-default-arg", "warning",
                    f"mutable/tensor default argument in {fn.name!r} — "
                    f"evaluated once at import and shared across calls",
                    subject=filename, location=loc(default)))
        for n in nested:
            if isinstance(n, ast.FunctionDef) and all(
                    n not in set(ast.walk(m)) for m in nested if m is not n):
                visit_fn(n, inside_traced=is_traced)

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            visit_fn(node, inside_traced=False)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    visit_fn(sub, inside_traced=False)
    return findings


def default_lint_root() -> str:
    """The installed ``repro_torch`` package directory (==
    src/repro_torch)."""
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def lint_paths(paths: Optional[Iterable[str]] = None) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (default: the whole
    ``repro_torch`` package)."""
    if paths is None:
        paths = [default_lint_root()]
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(root) for f in fs
                if f.endswith(".py"))
        for path in files:
            with open(path, "r") as fh:
                src = fh.read()
            rel = os.path.relpath(path, os.path.dirname(
                default_lint_root()))
            findings.extend(lint_source(src, filename=rel))
    return findings
