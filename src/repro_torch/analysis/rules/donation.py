"""ZL002: stale aliases of rebound device state (PyTorch).

The reference's rule catches a read of a buffer after ``jax.jit``
donated it.  Eager PyTorch donates nothing, but the port has the same
hazard one level up: a call that REBINDS a runner's or a store's device
state.  ``park`` drops ``self.layers``/``self.cache``/``self.params``
and the store's ``k_pages``/``v_pages`` (``drop_arrays``), ``unpark``
rebuilds them as new tensors (``ensure_arrays``, ``tree_from_host``),
and ``migrate_out``/``migrate_in`` move a request's KV between the
replicas' grants.  A local alias taken before such a call::

    kp = runner.store.k_pages[layer]
    runner.unpark(state, restored)
    kp[page] = ...          # writes the OLD tensor: silently lost

reads (or writes) the tensors the owner no longer holds -- and only
after a park, so a test that never parks never sees it.  The rule tracks
aliases -- a name bound straight to a dotted path ending in one of the
rebound attributes, or to an index of one -- and flags any read of an
alias after a rebinding call in the same function, unless the name was
bound again from its owner first: the reference's rebinding idiom, and
the clean case.  The rebinding call's own statement is exempt (its reads
are its arguments).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Tuple

from repro_torch.analysis.engine import Module, Rule, dotted, stmt_exprs
from repro_torch.analysis.rules.common import assigned_names

#: calls that rebind a runner's or a store's device state
REBINDING_CALLS = {"park", "unpark", "migrate_out", "migrate_in",
                   "drop_arrays", "ensure_arrays"}
#: the device state they rebind
REBOUND_ATTRS = {"cache", "layers", "params", "k_pages", "v_pages"}


def _alias_source(node: ast.AST) -> Optional[str]:
    """The rebound dotted path ``node`` aliases (``self.store.k_pages``
    for ``self.store.k_pages[layer]``), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Attribute):
        return None
    d = dotted(node)
    if d is None or node.attr not in REBOUND_ATTRS:
        return None
    return d


def _pairs(stmt: ast.Assign):
    for t in stmt.targets:
        if (isinstance(t, (ast.Tuple, ast.List))
                and isinstance(stmt.value, (ast.Tuple, ast.List))
                and len(t.elts) == len(stmt.value.elts)):
            yield from zip(t.elts, stmt.value.elts)
        else:
            yield t, stmt.value


def _reads(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               and isinstance(n.ctx, ast.Load) for n in ast.walk(node))


class DonationAfterUse(Rule):
    rule_id = "ZL002"
    title = "aliases of device state read after a call rebinds it"

    def run(self, mod: Module) -> Iterator[Tuple[int, str]]:
        for func in mod.functions():
            # alias name -> the path it was taken from
            alias: Dict[str, str] = {}
            # dead alias -> (rebinding callee, call line)
            dead: Dict[str, Tuple[str, int]] = {}
            for stmt in func.statements():
                for name, (callee, line) in list(dead.items()):
                    if any(_reads(e, name) for e in stmt_exprs(stmt)):
                        yield (stmt.lineno,
                               f"'{name}' aliases {alias.get(name, '?')}, "
                               f"which {callee}() at line {line} may have "
                               "rebound: this reads the old tensors -- "
                               "read it again from its owner after the "
                               "call")
                        del dead[name]
                rebinds = [c for e in stmt_exprs(stmt) for c in ast.walk(e)
                           if isinstance(c, ast.Call)
                           and isinstance(c.func, ast.Attribute)
                           and c.func.attr in REBINDING_CALLS]
                # (re)bindings of this statement
                if isinstance(stmt, ast.Assign):
                    for tgt, val in _pairs(stmt):
                        src = _alias_source(val)
                        for path in assigned_names(tgt):
                            dead.pop(path, None)
                            if src is not None and "." not in path:
                                alias[path] = src
                            else:
                                alias.pop(path, None)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    d = dotted(stmt.target)
                    if d is not None:
                        dead.pop(d, None)
                        alias.pop(d, None)
                if rebinds:
                    stores = set()
                    if isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            stores |= assigned_names(t)
                    for name in alias:
                        if name not in stores:
                            dead[name] = (rebinds[0].func.attr,
                                          stmt.lineno)
