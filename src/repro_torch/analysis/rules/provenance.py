"""ZL001: page-id provenance -- view-local ids vs physical ids.

The isolation boundary of multi-tenant serving is a *unit system*:
requests hold **view-local** page ids (``req.pages``/``req.local_pages``,
everything a ``PoolView``/``PagePool`` grant returns), while the device
page arrays, the shared free lists, and the decode kernel's page tables
speak **physical** ids.  ``to_physical``/``to_physical_local`` (and the
runner's ``_phys``/``_phys_local`` wrappers) are the only conversion --
and it raises on ids the view no longer owns, which is the whole guard.

Mixing the units never fails loudly on a private pool (the remap is the
identity there), so the bug ships and only detonates under tenancy.
This rule flow-tracks both taints per function and flags:

* a view-local value reaching a physical sink: ``page_table(pages=...)``,
  ``SharedPagePool._give``, or a shared free list's ``extend``;
* a physical value stored back onto a request (``req.pages = phys`` /
  ``req.pages.extend(phys)``) -- requests must only ever hold view ids;
* a physical value translated *again* through ``to_physical*`` -- double
  translation reads some other tenant's pages when ids happen to alias.

The prefix cache (serving/prefix_cache.py) introduces a SECOND class of
physical ids that legitimately lives on requests: ``req.shared_pages``
holds cache-owned physical page ids (and ``PrefixMatch.phys_pages`` is
their source).  These are recognized provenance sources -- reading them
taints PHYS, so translating them again or freeing them as view ids is
flagged -- and the dual sinks hold: a VIEW value assigned or extended
into ``shared_pages`` is flagged (the cache speaks physical only;
``cache_donate`` is the conversion, ``cow_grant`` returns view ids).

**Interprocedural flow**: ids routinely cross helper boundaries --
``def _free_pages(pool, ids): pool._give(ids)`` called with
``req.pages`` is the same bug as the inline version, invisible to a
per-function pass.  The rule therefore builds a module-level summary of
every locally defined, unambiguously named function: (a) the taint its
return value carries (fixed VIEW/PHYS, or pass-through of parameter i),
and (b) which parameters reach a physical sink (flagging VIEW
arguments) or a re-translation (flagging PHYS arguments) inside the
body.  Summaries are iterated to a fixpoint so taint follows chains of
helpers; the known-name sets above always take precedence over
summaries, and ambiguous names (two defs sharing a leaf name) are
skipped rather than guessed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.engine import (Module, Rule, dotted, own_statements,
                                   stmt_calls)

VIEW = "view-local"
PHYS = "physical"

#: grant APIs: whatever they return is what requests hold (view ids);
#: cow_grant is a one-page grant from the request's own pool/view
VIEW_CALLS = {"_alloc", "_alloc_local", "_new_ids", "cow_grant"}
#: translation / physical-side APIs: results are physical ids;
#: cache_donate converts view ids to physical as ownership moves to the
#: prefix cache
PHYS_CALLS = {"to_physical", "to_physical_local", "_phys", "_phys_local",
              "reclaim", "_take", "cache_donate"}
#: remap tables: indexing or popping one yields a physical id
REMAP_NAMES = {"_remap", "_remap_local"}
#: request attributes that hold view-local ids
REQ_ID_ATTRS = ("pages", "local_pages")
#: attributes that hold cache-owned PHYSICAL ids (prefix cache): reading
#: one taints physical; writing view ids into one is a sink
PHYS_ATTRS = ("shared_pages", "phys_pages")
#: physical-side free lists: extending one with view ids corrupts the pool
PHYS_FREE_NAMES = {"free_local"}

#: pass-through wrappers: taint flows through the first argument
TRANSPARENT_CALLS = {"list", "sorted", "reversed", "tuple", "asarray",
                     "array"}


#: leaf names that must never be shadowed by summaries: the built-in
#: provenance/sink vocabulary always wins, and the pool-accounting
#: verbs are POLYMORPHIC (PoolView overrides them to translate through
#: its remap) -- summarizing one class's body as the behavior of every
#: ``self._dealloc*`` dispatch would indict correct callers
_KNOWN_NAMES = (VIEW_CALLS | PHYS_CALLS | TRANSPARENT_CALLS
                | {"page_table", "_give", "extend", "pop",
                   "_dealloc", "_dealloc_local", "release", "reclaim",
                   "regrant", "grow", "try_admit"})

#: summary fixpoint bound (helper-chain depth the analysis follows)
_MAX_ROUNDS = 4


def _leaf(path: Optional[str]) -> Optional[str]:
    return None if path is None else path.rsplit(".", 1)[-1]


@dataclass
class _FnSummary:
    """Interprocedural facts about one locally defined function."""

    params: List[str]
    #: VIEW / PHYS when every valued return carries that taint;
    #: ("param", i) when the function passes parameter i through
    returns: Optional[object] = None
    #: parameter indices that reach a physical sink (a VIEW argument at
    #: the call site is the caller's bug)
    flags_view: frozenset = field(default_factory=frozenset)
    #: parameter indices translated through to_physical* inside (a PHYS
    #: argument is a double translation)
    flags_phys: frozenset = field(default_factory=frozenset)

    def call_arg(self, call: ast.Call, idx: int) -> Optional[ast.AST]:
        """The call-site expression bound to parameter ``idx``:
        attribute calls (``self._helper(x)``) skip an explicit
        self/cls first parameter; keywords match by parameter name."""
        if not (0 <= idx < len(self.params)):
            return None
        pos = idx
        if (isinstance(call.func, ast.Attribute)
                and self.params[0] in ("self", "cls")):
            pos -= 1
        if 0 <= pos < len(call.args):
            return call.args[pos]
        for kw in call.keywords:
            if kw.arg == self.params[idx]:
                return kw.value
        return None


class PageIdProvenance(Rule):
    rule_id = "ZL001"
    title = "view-local vs physical page-id provenance"

    def __init__(self):
        self._sum: Dict[str, _FnSummary] = {}

    # -- expression taint ---------------------------------------------------
    def _taint(self, node: ast.AST, env: Dict[str, str]) -> Optional[str]:
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted(node)
            if d is None:
                return None
            if d in env:
                return env[d]
            if _leaf(d) in PHYS_ATTRS and "." in d:
                return PHYS
            if _leaf(d) in REQ_ID_ATTRS and "." in d:
                return VIEW
            return None
        if isinstance(node, ast.Call):
            leaf = _leaf(dotted(node.func))
            if leaf in PHYS_CALLS:
                return PHYS
            if leaf in VIEW_CALLS:
                return VIEW
            if leaf == "pop":
                base = _leaf(dotted(getattr(node.func, "value", None)))
                if base in REMAP_NAMES:
                    return PHYS
            if leaf in TRANSPARENT_CALLS and node.args:
                return self._taint(node.args[0], env)
            s = self._sum.get(leaf)
            if s is not None:
                r = s.returns
                if isinstance(r, tuple) and r and r[0] == "param":
                    arg = s.call_arg(node, r[1])
                    return None if arg is None else self._taint(arg, env)
                if r in (VIEW, PHYS):
                    return r
            return None
        if isinstance(node, ast.Subscript):
            base = _leaf(dotted(node.value))
            if base in REMAP_NAMES:
                return PHYS
            return self._taint(node.value, env)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            inner = dict(env)
            for gen in node.generators:
                if isinstance(gen.target, ast.Name):
                    t = self._taint(gen.iter, env)
                    if t is not None:
                        inner[gen.target.id] = t
            return self._taint(node.elt, inner)
        if isinstance(node, ast.BinOp):
            return (self._taint(node.left, env)
                    or self._taint(node.right, env))
        if isinstance(node, ast.IfExp):
            a = self._taint(node.body, env)
            b = self._taint(node.orelse, env)
            return a if a == b else (a or b)
        if isinstance(node, ast.Starred):
            return self._taint(node.value, env)
        return None

    # -- sinks --------------------------------------------------------------
    def _check_call(self, call: ast.Call,
                    env: Dict[str, str]) -> Iterator[Tuple[int, str]]:
        leaf = _leaf(dotted(call.func))
        if leaf == "page_table":
            for kw in call.keywords:
                if kw.arg == "pages" and self._taint(kw.value, env) == VIEW:
                    yield (kw.value.lineno,
                           "view-local page ids reach page_table(pages=...):"
                           " the kernel indexes the device arrays by "
                           "PHYSICAL ids -- translate via "
                           "pool.to_physical() first")
        elif leaf == "_give":
            for arg in call.args:
                if self._taint(arg, env) == VIEW:
                    yield (arg.lineno,
                           "view-local ids returned to the shared pool's "
                           "physical free list (_give): translate via the "
                           "remap before freeing")
        elif leaf in ("to_physical", "to_physical_local",
                      "_phys", "_phys_local"):
            for arg in call.args:
                if self._taint(arg, env) == PHYS:
                    yield (arg.lineno,
                           f"already-physical ids translated again through "
                           f"{leaf}(): double translation resolves through "
                           "the wrong view's remap")
        elif leaf == "extend":
            base = dotted(getattr(call.func, "value", None))
            if (_leaf(base) in PHYS_FREE_NAMES and call.args
                    and self._taint(call.args[0], env) == VIEW):
                yield (call.lineno,
                       "view-local ids pushed onto a physical free list "
                       f"({base}.extend): free the PHYSICAL ids instead")
            if (base is not None and _leaf(base) in REQ_ID_ATTRS
                    and "." in base and call.args
                    and self._taint(call.args[0], env) == PHYS):
                yield (call.lineno,
                       f"physical ids appended to {base}: requests must "
                       "hold view-local ids only (grants already return "
                       "them)")
            if (base is not None and _leaf(base) in PHYS_ATTRS
                    and "." in base and call.args
                    and self._taint(call.args[0], env) == VIEW):
                yield (call.lineno,
                       f"view-local ids appended to {base}: the prefix "
                       "cache holds PHYSICAL ids only -- convert via "
                       "cache_donate()/to_physical() first")
        else:
            s = self._sum.get(leaf)
            if s is None:
                return
            for i in sorted(s.flags_view):
                arg = s.call_arg(call, i)
                if arg is not None and self._taint(arg, env) == VIEW:
                    yield (arg.lineno,
                           f"view-local ids passed to {leaf}() parameter "
                           f"{s.params[i]!r}, which {leaf}() forwards to "
                           "a physical sink: translate via "
                           "pool.to_physical() first")
            for i in sorted(s.flags_phys):
                arg = s.call_arg(call, i)
                if arg is not None and self._taint(arg, env) == PHYS:
                    yield (arg.lineno,
                           f"already-physical ids passed to {leaf}() "
                           f"parameter {s.params[i]!r}, which {leaf}() "
                           "translates again: double translation "
                           "resolves through the wrong view's remap")

    # -- per-function flow (shared by the driver and the summarizer) --------
    def _flow(self, func, env0: Dict[str, str], stmts=None):
        """One tainted walk of ``func`` under initial bindings ``env0``.
        Returns ``(findings, returns)`` where ``returns`` pairs each of
        the function's OWN valued return expressions with its taint."""
        findings: List[Tuple[int, str]] = []
        rets: List[Tuple[ast.AST, Optional[str]]] = []
        own = {id(s) for s in own_statements(func.node)}
        env: Dict[str, str] = dict(env0)
        for stmt in (func.statements() if stmts is None else stmts):
            # sinks first: the env of a statement is everything bound
            # strictly before it
            for call in stmt_calls(stmt):
                findings.extend(self._check_call(call, env))
            if (isinstance(stmt, ast.Return) and id(stmt) in own
                    and stmt.value is not None):
                rets.append((stmt.value, self._taint(stmt.value, env)))
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
                if (len(targets) == 1
                        and isinstance(targets[0], (ast.Tuple, ast.List))
                        and isinstance(stmt.value,
                                       (ast.Tuple, ast.List))
                        and len(targets[0].elts)
                        == len(stmt.value.elts)):
                    pairs = zip(targets[0].elts, stmt.value.elts)
                elif len(targets) == 1:
                    pairs = [(targets[0], stmt.value)]
                else:
                    pairs = [(t, stmt.value) for t in targets]
                for tgt, val in pairs:
                    d = dotted(tgt)
                    if d is None:
                        continue
                    t = self._taint(val, env)
                    if (_leaf(d) in REQ_ID_ATTRS and "." in d
                            and t == PHYS):
                        findings.append(
                            (stmt.lineno,
                             f"physical ids stored on {d}: requests "
                             "must hold view-local ids (the remap is "
                             "the isolation boundary)"))
                    if (_leaf(d) in PHYS_ATTRS and "." in d
                            and t == VIEW):
                        findings.append(
                            (stmt.lineno,
                             f"view-local ids stored on {d}: the "
                             "prefix cache's pages are PHYSICAL -- "
                             "a view id here reads another tenant's "
                             "pages when ids alias"))
                    if t is None:
                        env.pop(d, None)
                    else:
                        env[d] = t
            elif isinstance(stmt, ast.For):
                if isinstance(stmt.target, ast.Name):
                    t = self._taint(stmt.iter, env)
                    if t is not None:
                        env[stmt.target.id] = t
        return findings, rets

    # -- interprocedural summaries ------------------------------------------
    def _summarize(self, mod: Module) -> None:
        """Fixpoint over the module's unambiguously named functions:
        each round re-derives every summary under the previous round's
        summaries, so taint follows helper chains."""
        byname: Dict[str, List] = {}
        for f in mod.functions():
            byname.setdefault(f.name, []).append(f)
        cands = {n: fs[0] for n, fs in byname.items()
                 if len(fs) == 1 and n not in _KNOWN_NAMES}
        stmt_cache = {n: f.statements() for n, f in cands.items()}
        self._sum = {}
        for _ in range(_MAX_ROUNDS):
            new: Dict[str, _FnSummary] = {}
            for name, func in cands.items():
                a = func.node.args
                params = [p.arg for p in a.posonlyargs + a.args]
                stmts = stmt_cache[name]
                base, rets = self._flow(func, {}, stmts)
                fv, fp = set(), set()
                for i, p in enumerate(params):
                    if len(self._flow(func, {p: VIEW}, stmts)[0]) \
                            > len(base):
                        fv.add(i)
                    if len(self._flow(func, {p: PHYS}, stmts)[0]) \
                            > len(base):
                        fp.add(i)
                taints = {t for _, t in rets}
                ret = None
                if rets and None not in taints and len(taints) == 1:
                    ret = next(iter(taints))
                elif (rets and taints == {None}
                      and all(isinstance(e, ast.Name) for e, _ in rets)
                      and len({e.id for e, _ in rets}) == 1
                      and rets[0][0].id in params):
                    ret = ("param", params.index(rets[0][0].id))
                new[name] = _FnSummary(params=params, returns=ret,
                                       flags_view=frozenset(fv),
                                       flags_phys=frozenset(fp))
            if new == self._sum:
                break
            self._sum = new

    # -- driver -------------------------------------------------------------
    def run(self, mod: Module) -> Iterator[Tuple[int, str]]:
        self._summarize(mod)
        for func in mod.functions():
            yield from self._flow(func, {})[0]
