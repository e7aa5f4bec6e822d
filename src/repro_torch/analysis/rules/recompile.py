"""ZL003: recompile hazards -- per-request values becoming compile or
capture keys (PyTorch).

Bursty serving stays O(1)-compile only because every value that reaches
a compile key is *bucketed* first: batch padded to ``max_batch``,
page-table width to the next power of two, prompts to whole pages.  In
the port the decode step stages its inputs in numpy at those padded
shapes (``PagedRunner.decode``), and they are the buckets a CUDA-graph
capture of the step will key on: one raw ``len(running)`` in a staging
shape and every batch size becomes its own graph.  In hot-path functions
(the reference's convention, closed over the helpers they call through
``self.``: :mod:`repro_torch.analysis.rules.common`) the rule flags:

* a per-request, non-bucketed expression inside the shape argument of a
  host-side staging-array constructor (``zeros``/``ones``/``full``/
  ``empty``) -- those shapes feed straight into the compile or capture
  key of the call they are staged for (the reference's clause,
  unchanged);
* ``torch.compile(...)``, ``torch.cuda.CUDAGraph()`` or
  ``torch.cuda.graph(...)`` built inside the hot path itself -- a fresh
  compiled wrapper or capture never hits a cache, so it recompiles (or
  recaptures) on every call;
* a per-request-shaped name passed to a callable bound from
  ``torch.compile`` in this module (its shapes are guards of the
  compiled graph, so each new one recompiles);
* a per-request, non-bucketed key into a cache of compiled or captured
  callables -- a dict or list whose items are assigned from
  ``torch.compile``/``torch.cuda.CUDAGraph()`` somewhere in the module:
  the torch counterpart of the reference's ``static_argnums`` clause.
  The port keys no compiled or captured callable yet (its decode runs
  eagerly); the clause is the guard for the bucketed graph table a
  captured decode step will index, and its fixture shows the idiom.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set, Tuple

from repro_torch.analysis.engine import (Module, Rule, dotted,
                                         is_compile_call, stmt_calls,
                                         stmt_exprs)
from repro_torch.analysis.rules.common import (classify_env, hot_functions,
                                               is_bucketed,
                                               is_request_derived)

STAGING_CONSTRUCTORS = {"zeros", "ones", "full", "empty"}
CAPTURE_CALLS = ("torch.cuda.CUDAGraph", "torch.cuda.graph")


def _leaf(path: Optional[str]) -> Optional[str]:
    return None if path is None else path.rsplit(".", 1)[-1]


def _builds_compiled(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (is_compile_call(node) or dotted(node.func) in CAPTURE_CALLS))


def _keyed_caches(mod: Module) -> Set[str]:
    """Dotted paths of the module's caches of compiled or captured
    callables: ``<path>[key] = torch.compile(...)`` or
    ``<path>.setdefault(key, torch.cuda.CUDAGraph())``."""
    out: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and _builds_compiled(node.value):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    d = dotted(t.value)
                    if d is not None:
                        out.add(d)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "setdefault" and len(node.args) == 2
              and _builds_compiled(node.args[1])):
            d = dotted(node.func.value)
            if d is not None:
                out.add(d)
    return out


class RecompileHazard(Rule):
    rule_id = "ZL003"
    title = "per-request values reaching compile/capture keys in hot paths"

    def run(self, mod: Module) -> Iterator[Tuple[int, str]]:
        compiled = mod.compiled_bindings()
        caches = _keyed_caches(mod)
        for func in hot_functions(mod):
            env = classify_env(func)
            for stmt in func.statements():
                for call in stmt_calls(stmt):
                    yield from self._check_call(call, env, compiled, caches)
                for expr in _own_subscripts(stmt):
                    yield from self._check_key(expr, env, caches)

    def _check_key(self, sub: ast.Subscript, env, caches):
        if dotted(sub.value) in caches and self._hazard(sub.slice, env):
            yield (sub.lineno,
                   f"per-request key into {dotted(sub.value)}, a cache of "
                   "compiled/captured callables: every distinct value "
                   "compiles or captures afresh -- bucket it first")

    @staticmethod
    def _hazard(node: ast.AST, env) -> bool:
        return is_request_derived(node, env) and not is_bucketed(node, env)

    def _check_call(self, call: ast.Call, env, compiled, caches):
        d = dotted(call.func)
        leaf = _leaf(d)
        if is_compile_call(call) or d in CAPTURE_CALLS:
            yield (call.lineno,
                   f"{d} built inside a hot path: a fresh compiled wrapper "
                   "or capture never hits a cache -- build it once (per "
                   "bucket) outside and call the bound version here")
            return
        if leaf in STAGING_CONSTRUCTORS and call.args:
            shape = call.args[0]
            if self._hazard(shape, env):
                yield (shape.lineno,
                       f"per-request value in the shape of a staging "
                       f"{leaf}(): this shape becomes a compile/capture key "
                       "-- bucket it (max_batch padding, _next_pow2, page "
                       "math) first")
            return
        if (leaf in ("get", "setdefault") and call.args
                and isinstance(call.func, ast.Attribute)
                and dotted(call.func.value) in caches
                and self._hazard(call.args[0], env)):
            yield (call.lineno,
                   f"per-request key into {dotted(call.func.value)}, a "
                   "cache of compiled/captured callables: every distinct "
                   "value compiles or captures afresh -- bucket it first")
            return
        if leaf not in compiled:
            return
        # a per-request-SHAPED tensor recompiles a torch.compile'd callable
        # just as surely: its shape is guarded.  Bare names only, as the
        # reference's clause.
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            for n in ast.walk(arg):
                if isinstance(n, ast.Name) and env.get(n.id) == "request":
                    yield (call.lineno,
                           f"'{n.id}' is a per-request-shaped value passed "
                           f"to compiled {leaf}(): its shape is a guard of "
                           "the compiled graph -- bucket it (pad to a page/"
                           "power-of-two boundary) first")


def _own_subscripts(stmt: ast.stmt) -> Iterator[ast.Subscript]:
    """Subscript loads in the statement's own expressions."""
    for expr in stmt_exprs(stmt):
        for n in ast.walk(expr):
            if (isinstance(n, ast.Subscript)
                    and isinstance(n.ctx, ast.Load)):
                yield n
