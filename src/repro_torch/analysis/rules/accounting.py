"""ZL005: pool-accounting pairing -- reclaim receipts must be consumed.

``reclaim``/``drain``/``park``/``regrant`` are the four verbs that move
pages and bytes between an application and the pod, and every one of
them RETURNS the evidence of what moved: reclaim/drain hand back the
physical ids whose contents must be snapshotted before co-tenants reuse
them, ``scheduler.park`` returns the freed bytes unpark must reacquire,
and ``regrant`` returns whether the pages came back at all.  Dropping
any of these on the floor is how pages get stranded and parked apps
become unresumable -- silently, because the accounting still "adds up"
until the next unpark.

The prefix cache adds three more receipt verbs: ``pin`` returns the
match (pinned node chain + physical pages) that MUST later be unpinned,
``unpin`` returns how many refcounts hit zero (the eviction-eligibility
signal the caller folds into stats), and ``cow_grant`` returns the
granted copy-target page or ``None`` -- ignoring it either leaks the
page or dereferences a failed grant.

This rule flags, per function:

* a receipt-bearing call used as a bare expression statement (the
  result is discarded outright);
* a receipt bound to a name that is never read afterwards;
* an early ``return`` between binding a receipt and its first use --
  the exit path walks off with pages reclaimed but their receipt
  unconsumed (the "all exits" half of the invariant, approximated
  lexically).

**Interprocedural flow**: a helper that merely relays a receipt --
``def _park_all(pool, req): return pool.reclaim(req)`` -- launders the
verb name away, so a caller discarding ``_park_all(...)`` drops the
same pages the inline version would.  The rule therefore widens the
verb set per module: a locally defined, unambiguously named function
whose every valued ``return`` is a receipt call (directly, or a bare
name bound straight from one) is itself receipt-bearing for its
callers.  The criterion is deliberately strict -- a function returning
a dict that merely *contains* a receipt (``parking.park_app``) keeps
custody of it and is NOT widened -- and iterates to a fixpoint so
chains of relays are followed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

from repro_torch.analysis.engine import (Module, Rule, dotted, own_statements,
                                   stmt_exprs)

RECEIPT_CALLS = {"reclaim", "drain", "park", "regrant",
                 "pin", "unpin", "cow_grant"}

#: fixpoint bound for relay chains (helper returning a helper's receipt)
_MAX_ROUNDS = 4


def _leaf(path: Optional[str]) -> Optional[str]:
    return None if path is None else path.rsplit(".", 1)[-1]


def _receipt_call(node: ast.AST, verbs: Set[str]) -> Optional[str]:
    if isinstance(node, ast.Call):
        leaf = _leaf(dotted(node.func))
        if leaf in verbs:
            return leaf
    return None


def _reads_name(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               and isinstance(n.ctx, ast.Load)
               for n in ast.walk(node))


class AccountingPairing(Rule):
    rule_id = "ZL005"
    title = "reclaim/park receipts must be consumed on every path"

    def _verbs(self, mod: Module) -> Set[str]:
        """RECEIPT_CALLS widened with the module's receipt-relaying
        functions (every valued return IS a receipt, see module doc)."""
        byname: Dict[str, list] = {}
        for f in mod.functions():
            byname.setdefault(f.name, []).append(f)
        cands = {n: fs[0] for n, fs in byname.items()
                 if len(fs) == 1 and n not in RECEIPT_CALLS}
        verbs = set(RECEIPT_CALLS)
        for _ in range(_MAX_ROUNDS):
            grown = False
            for name, func in cands.items():
                if name in verbs:
                    continue
                relayed: Dict[str, bool] = {}
                valued, all_receipts = 0, True
                for stmt in own_statements(func.node):
                    if (isinstance(stmt, ast.Return)
                            and stmt.value is not None):
                        valued += 1
                        v = stmt.value
                        if not (_receipt_call(v, verbs) is not None
                                or (isinstance(v, ast.Name)
                                    and relayed.get(v.id, False))):
                            all_receipts = False
                        continue
                    # any intermediate read means the helper consumed
                    # the receipt itself (e.g. folding a count into
                    # stats) -- its return value is informational, not
                    # a relayed receipt
                    for expr in stmt_exprs(stmt):
                        for name in [n for n, ok in relayed.items()
                                     if ok and _reads_name(expr, n)]:
                            relayed[name] = False
                    if (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)):
                        relayed[stmt.targets[0].id] = (
                            _receipt_call(stmt.value, verbs) is not None)
                if valued and all_receipts:
                    verbs.add(name)
                    grown = True
            if not grown:
                break
        return verbs

    def run(self, mod: Module) -> Iterator[Tuple[int, str]]:
        verbs = self._verbs(mod)
        for func in mod.functions():
            # name -> (verb, bind line), pending first use
            pending: Dict[str, Tuple[str, int]] = {}
            for stmt in func.statements():
                # discarded outright: `pool.reclaim(req)` as a statement
                if isinstance(stmt, ast.Expr):
                    verb = _receipt_call(stmt.value, verbs)
                    if verb is not None:
                        yield (stmt.lineno,
                               f"result of {verb}() discarded: the receipt "
                               "(page ids / freed bytes / success flag) is "
                               "the only record of what moved -- consume "
                               "or propagate it")
                # early exit with receipts still unconsumed
                if isinstance(stmt, ast.Return):
                    returns = stmt.value
                    for name, (verb, line) in list(pending.items()):
                        if returns is not None and _reads_name(returns,
                                                               name):
                            pending.pop(name)
                        else:
                            yield (stmt.lineno,
                                   f"return before '{name}' (the {verb}() "
                                   f"receipt bound at line {line}) is "
                                   "consumed: this exit strands the "
                                   "reclaimed pages/bytes")
                    continue
                # any read of a pending name counts as consumption
                for expr in stmt_exprs(stmt):
                    for used in [n for n in pending
                                 if _reads_name(expr, n)]:
                        pending.pop(used)
                # new receipt bindings (checked last: the binding
                # statement's own value is the call, not a consumption)
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt = stmt.targets[0]
                    verb = None
                    for n in ast.walk(stmt.value):
                        verb = verb or _receipt_call(n, verbs)
                    if verb is not None and isinstance(tgt, ast.Name):
                        pending[tgt.id] = (verb, stmt.lineno)
            for name, (verb, line) in pending.items():
                yield (line,
                       f"'{name}' holds a {verb}() receipt that is never "
                       "consumed in this function -- the reclaimed "
                       "pages/bytes have no paired regrant/release/"
                       "snapshot handling")
