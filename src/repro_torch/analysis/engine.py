"""zenlint rule engine of the port: files -> ASTs -> findings, with
suppressions.

The port's copy of ``repro/analysis/engine.py``.  The analyzer exists
because Zenix's hardest invariants are invisible to the type system:
view-local vs physical page ids are both ``List[int]``, a tensor rebound
by a park is an ordinary attribute, and a host sync is one innocuous
``int()``.  Each rule in :mod:`repro_torch.analysis.rules` encodes one
such invariant as an AST check; this module carries everything the rules
share:

* :class:`Finding` -- one diagnostic, addressable as ``path:line``.
* :class:`Module` -- a parsed file: source, AST, per-line suppressions,
  and the AST helpers every rule needs (dotted paths, function walks,
  the registry of ``torch.compile`` bindings).
* suppression parsing -- ``# zenlint-torch: ignore[ZL001] -- reason`` on
  the offending line (or as a standalone comment on the line above).
  The ``-- reason`` text is MANDATORY: a reasonless suppression does not
  suppress, it adds an extra ZL000 finding, so "zero unjustified
  suppressions" is machine-checkable.  The directive word differs from
  the reference's ``zenlint:`` on purpose: the reference's strict gate
  reads the port's files too, and would call a directive in its own
  word that suppresses nothing under its rules stale.
* :func:`analyze_paths` / :func:`analyze_source` -- the drivers the CLI
  and the fixture tests run.

Rules are heuristic by design (naming + call-graph conventions of THIS
repo), so every rule must hold two properties: a violation of the
written convention is flagged, and the idiomatic correct pattern is not.
Both are pinned by fixture tests per rule.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

#: rule id of engine-level diagnostics (parse errors, bad suppressions);
#: deliberately NOT suppressible -- the mechanism must not hide its own
#: failures.
ENGINE_RULE = "ZL000"

#: the port's directive word (``zenlint-torch``), which the reference's
#: pattern cannot match
_SUPPRESS_RE = re.compile(
    r"#\s*zenlint-torch:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(?:--\s*(\S.*))?")


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line: rule message``."""

    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    reason: str = ""

    def render(self) -> str:
        tail = f"  [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{tail}"


class Rule:
    """One invariant.  Subclasses yield ``(line, message)`` pairs."""

    rule_id = ENGINE_RULE
    title = ""

    def run(self, mod: "Module") -> Iterator[Tuple[int, str]]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# AST helpers shared by the rules
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """``self.store.k_pages`` for the matching Attribute/Name chain, or
    None when the expression is not a plain dotted path."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def last_name(node: ast.AST) -> Optional[str]:
    """Final component of a dotted path (``self._decode`` -> ``_decode``)."""
    d = dotted(node)
    return None if d is None else d.rsplit(".", 1)[-1]


def call_last_name(call: ast.Call) -> Optional[str]:
    return last_name(call.func)


def contains(node: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(node))


def loads_path(node: ast.AST, path: str) -> bool:
    """Whether ``node`` reads dotted ``path`` (or subscripts into it)."""
    def hit(n):
        return (isinstance(n, (ast.Name, ast.Attribute))
                and isinstance(getattr(n, "ctx", None), ast.Load)
                and dotted(n) == path)
    return contains(node, hit)


def stmt_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions belonging to ``stmt`` ITSELF: the whole node for
    simple statements, only the header expressions for compound ones
    (whose body statements a linearized walk visits separately -- walking
    the whole compound would double-count every nested expression)."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.While, ast.If)):
        return [stmt.test]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [it.context_expr for it in stmt.items]
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.Try)):
        return []
    return [stmt]


def stmt_calls(stmt: ast.stmt) -> Iterator[ast.Call]:
    """Every Call in the statement's OWN expressions (see stmt_exprs)."""
    for expr in stmt_exprs(stmt):
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                yield n


@dataclass
class FuncInfo:
    """One function/method with enough context for hot-path decisions."""

    node: ast.AST                      # FunctionDef | AsyncFunctionDef
    name: str
    qualname: str
    cls: Optional[str] = None          # enclosing class name, if any

    def statements(self) -> List[ast.stmt]:
        """Every statement in the body, linearized in source order (the
        rules reason about 'after the call' lexically -- a deliberate
        approximation of control flow)."""
        out = [n for n in ast.walk(self.node) if isinstance(n, ast.stmt)]
        out.remove(self.node)  # the def itself
        return sorted(out, key=lambda n: (n.lineno, n.col_offset))


def own_statements(node: ast.AST) -> List[ast.stmt]:
    """The function's OWN statements in source order -- unlike
    FuncInfo.statements() this does not descend into nested defs or
    classes, whose returns and bindings belong to a different frame.
    The interprocedural summaries (ZL001/ZL005) need this distinction:
    a nested closure's ``return`` says nothing about the enclosing
    function's return value."""
    out: List[ast.stmt] = []

    def visit(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.stmt):
                out.append(child)
            visit(child)

    visit(node)
    return sorted(out, key=lambda n: (n.lineno, n.col_offset))


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def _comment_tokens(source: str) -> Iterator[Tuple[int, int, str]]:
    """(line, col, text) of every real COMMENT token -- tokenizing (not
    regexing raw lines) so directives *mentioned* in docstrings don't
    count as directives."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError):
        return


class Suppressions:
    """Per-line ``# zenlint-torch: ignore[...]`` directives of one file.

    A trailing directive covers the physical line it sits on.  A
    standalone directive (a comment-only line) covers the next CODE
    line: blank lines and further comment lines are skipped, so a
    multi-line justification block works -- put the directive on the
    block's first line and the prose after the ``--``/on the following
    comment lines."""

    def __init__(self, source: str):
        self.by_line: Dict[int, Tuple[Set[str], str]] = {}
        self.unjustified: List[Tuple[int, str]] = []
        #: (line, rule) pairs that actually suppressed a finding --
        #: the complement is the stale set ``--strict-suppressions``
        #: reports
        self.used: Set[Tuple[int, str]] = set()
        lines = source.splitlines()
        comments = list(_comment_tokens(source))
        comment_only = {ln for ln, col, _ in comments
                        if lines[ln - 1][:col].strip() == ""}
        for lineno, col, text in comments:
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(1).split(",")
                     if r.strip()}
            reason = (m.group(2) or "").strip()
            if not reason:
                self.unjustified.append((lineno, ",".join(sorted(rules))))
                continue
            target = lineno
            if lineno in comment_only:
                target = lineno + 1
                while (target <= len(lines)
                       and (target in comment_only
                            or not lines[target - 1].strip())):
                    target += 1
            prev = self.by_line.get(target)
            if prev:
                rules = rules | prev[0]
                reason = f"{prev[1]}; {reason}"
            self.by_line[target] = (rules, reason)

    def reason_for(self, rule: str, line: int) -> Optional[str]:
        hit = self.by_line.get(line)
        if hit and rule.upper() in hit[0]:
            self.used.add((line, rule.upper()))
            return hit[1]
        return None

    def stale(self, ran_rules: Set[str]) -> Iterator[Tuple[int, str]]:
        """Directives that suppressed NOTHING this run, restricted to
        the rules that actually ran (a ``--rule``-filtered run must not
        call another rule's directive stale)."""
        for line, (rules, _reason) in sorted(self.by_line.items()):
            for rid in sorted(rules):
                if rid in ran_rules and (line, rid) not in self.used:
                    yield line, rid


# ---------------------------------------------------------------------------
# module context
# ---------------------------------------------------------------------------

@dataclass
class CompiledInfo:
    """One ``X = torch.compile(fn, ...)`` binding found in a module."""

    target: str                        # dotted target path (self._step)
    name: str                          # its last component (_step)
    line: int


def is_compile_call(call: ast.Call) -> bool:
    """Whether ``call`` is ``torch.compile(...)``."""
    return dotted(call.func) == "torch.compile"


class Module:
    """A parsed source file plus the shared per-module indexes."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppressions = Suppressions(source)
        self._compiled: Optional[Dict[str, CompiledInfo]] = None

    # -- function iteration --------------------------------------------------
    def functions(self) -> Iterator[FuncInfo]:
        def visit(node: ast.AST, prefix: str, cls: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    yield FuncInfo(child, child.name, qn, cls)
                    yield from visit(child, qn + ".", cls)
                elif isinstance(child, ast.ClassDef):
                    yield from visit(child, f"{prefix}{child.name}.",
                                     child.name)
        yield from visit(self.tree, "", None)

    # -- compiled-callable registry (ZL003) ---------------------------------
    def compiled_bindings(self) -> Dict[str, CompiledInfo]:
        """Every ``<target> = torch.compile(...)`` in the module, keyed by
        the target's LAST name: methods bind ``self._step`` in
        ``__init__`` and call ``self._step`` elsewhere, so the last
        component is the stable join key."""
        if self._compiled is not None:
            return self._compiled
        out: Dict[str, CompiledInfo] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = dotted(node.targets[0])
            if (target is None or not isinstance(node.value, ast.Call)
                    or not is_compile_call(node.value)):
                continue
            name = target.rsplit(".", 1)[-1]
            out[name] = CompiledInfo(target=target, name=name,
                                     line=node.lineno)
        self._compiled = out
        return out


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def default_rules() -> List[Rule]:
    from repro_torch.analysis.rules import ALL_RULES
    return [cls() for cls in ALL_RULES]


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Sequence[Rule]] = None,
                   strict_suppressions: bool = False) -> List[Finding]:
    """Findings of one source blob (suppressions applied, engine
    diagnostics included).  The fixture tests drive this directly.
    With ``strict_suppressions`` a directive that suppressed nothing is
    itself a finding: stale suppressions hide regressions of the VERY
    invariant they once excused, because the next real finding on that
    line inherits the old justification unseen."""
    rules = list(rules) if rules is not None else default_rules()
    try:
        mod = Module(path, source)
    except SyntaxError as e:
        return [Finding(ENGINE_RULE, path, e.lineno or 1,
                        f"parse error: {e.msg}")]
    findings: List[Finding] = []
    for lineno, ruleset in mod.suppressions.unjustified:
        findings.append(Finding(
            ENGINE_RULE, path, lineno,
            f"suppression of [{ruleset}] without a '-- reason': a "
            "justification is mandatory (and this directive is ignored)"))
    for rule in rules:
        seen = set()
        for line, message in rule.run(mod):
            if (line, message) in seen:
                continue
            seen.add((line, message))
            reason = mod.suppressions.reason_for(rule.rule_id, line)
            findings.append(Finding(rule.rule_id, path, line, message,
                                    suppressed=reason is not None,
                                    reason=reason or ""))
    if strict_suppressions:
        ran = {r.rule_id for r in rules}
        for line, rid in mod.suppressions.stale(ran):
            findings.append(Finding(
                ENGINE_RULE, path, line,
                f"stale suppression of [{rid}]: no {rid} finding on "
                "this line -- the invariant holds again, delete the "
                "directive before it silently excuses the next real "
                "finding"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Sequence[Rule]] = None,
                  strict_suppressions: bool = False) -> List[Finding]:
    rules = list(rules) if rules is not None else default_rules()
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        findings.extend(analyze_source(source, path, rules,
                                       strict_suppressions))
    return findings
