"""Heuristics shared by several rules: what is a hot path, and what
expressions smell like per-request values vs bucketed ones.  The port's
copy of ``repro/analysis/rules/common.py``, plus :func:`hot_functions`.

These encode *this repo's* conventions (they are what make the rules
precise enough to gate CI):

* hot paths are the per-token serving functions -- ``decode``/``prefill``
  (and the ``_decode_fn``/``_prefill_fn`` names of the reference's
  traced bodies) on ``*Runner`` classes, and the per-tick methods of
  ``*Engine`` classes.  Everything there runs once per generated token
  across every request of a pod.  In the port a hot method does much of
  its work in helpers it calls through ``self.`` (``_first_token``,
  ``_record_margins``, ``_chunk_forward``), which run as often as it
  does: :func:`hot_functions` closes the set over them.
* per-request values are expressions rooted at a request object
  (``req``/``r``/``request``) or at the engine's ``running``/``requests``
  lists -- exactly the values that vary call-to-call and must therefore
  never become a compile or capture key.
* bucketing launders a per-request value into an O(1)-cardinality one:
  a floor division (page math: ``// PAGE_SIZE``) or one of the explicit
  helpers (``_next_pow2``, anything with ``bucket`` in its name).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.engine import FuncInfo, dotted

#: method names that are hot per class-name suffix
HOT_METHODS = {
    "Runner": {"decode", "prefill", "_decode_fn", "_prefill_fn"},
    "Engine": {"step", "_admit", "_reclaim", "preempt", "preempt_newest"},
}

#: names that (by convention) hold a Request / the running-request list
REQUEST_ROOTS = {"req", "r", "request", "victim", "running", "requests"}

#: calls that turn a per-request value into a bounded compile key
BUCKET_HELPERS = ("_next_pow2", "next_pow2")

#: builtin reducers whose results are scalars -- a traced scalar is not
#: a shape, so names assigned from these never carry the 'request' mark
SCALAR_BUILTINS = {"max", "min", "len", "sum", "int", "float", "abs",
                   "round", "bool"}


def is_hot_path(func: FuncInfo) -> bool:
    if func.cls is not None:
        for suffix, methods in HOT_METHODS.items():
            if func.cls.endswith(suffix) and func.name in methods:
                return True
    return False


def hot_functions(mod) -> List[FuncInfo]:
    """The module's hot paths (:func:`is_hot_path`) and, transitively,
    every method they call as ``self.<name>(...)``.  A name resolves to
    each method of that name on a class of the module (an inherited
    helper lives on a base class there); calls through another object
    (``self.model.prefill``, ``self.pool.grow``) are not followed."""
    funcs = list(mod.functions())
    methods: Dict[str, List[FuncInfo]] = {}
    for f in funcs:
        if f.cls is not None:
            methods.setdefault(f.name, []).append(f)
    hot = [f for f in funcs if is_hot_path(f)]
    seen = {id(f.node) for f in hot}
    todo = list(hot)
    while todo:
        for n in ast.walk(todo.pop().node):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "self"):
                continue
            for g in methods.get(n.func.attr, ()):
                if id(g.node) not in seen:
                    seen.add(id(g.node))
                    hot.append(g)
                    todo.append(g)
    return hot


def _root(path: str) -> str:
    return path.split(".", 1)[0]


def is_request_derived(node: ast.AST,
                       env: Optional[Dict[str, str]] = None) -> bool:
    """Whether the expression (transitively) reads per-request data:
    a dotted path rooted at a request-ish name, or a name the caller's
    ``env`` already classified as request-derived."""
    env = env or {}
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            if n.id in REQUEST_ROOTS or env.get(n.id) == "request":
                return True
        elif isinstance(n, ast.Attribute):
            d = dotted(n)
            if d is not None and _root(d) in REQUEST_ROOTS:
                return True
    return False


def is_bucketed(node: ast.AST,
                env: Optional[Dict[str, str]] = None) -> bool:
    """Whether the expression passes through a bucketing step (floor
    division or an explicit bucket helper), directly or via a name the
    caller's ``env`` classified as bucketed."""
    env = env or {}
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv):
            return True
        if isinstance(n, ast.Name) and env.get(n.id) == "bucketed":
            return True
        if isinstance(n, ast.Call):
            callee = dotted(n.func)
            if callee is not None:
                leaf = callee.rsplit(".", 1)[-1]
                if leaf in BUCKET_HELPERS or "bucket" in leaf:
                    return True
    return False


def classify_env(func: FuncInfo) -> Dict[str, str]:
    """Name -> 'bucketed' | 'request' for simple assignments, in source
    order (bucketed wins: laundering is the point of the helpers)."""
    env: Dict[str, str] = {}
    for stmt in func.statements():
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        t = stmt.targets[0]
        if not isinstance(t, ast.Name):
            continue
        value = stmt.value
        scalar = (isinstance(value, ast.Call)
                  and isinstance(value.func, ast.Name)
                  and value.func.id in SCALAR_BUILTINS)
        if is_bucketed(value, env):
            env[t.id] = "bucketed"
        elif is_request_derived(value, env) and not scalar:
            env[t.id] = "request"
        else:
            env.pop(t.id, None)
    return env


def assigned_names(target: ast.AST) -> Set[str]:
    """Flat set of dotted paths a (possibly tuple) target binds."""
    out: Set[str] = set()
    if isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            out |= assigned_names(e)
    else:
        d = dotted(target)
        if d is not None:
            out.add(d)
    return out
