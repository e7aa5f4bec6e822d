"""zenlint over the port (``repro_torch.analysis``), held against the
reference's analyzer.

The reference's four layers (``tests/test_zenlint.py``) on the port's
fixtures (``tests/zenlint_torch_fixtures``):

* fixture cross-check -- each fixture carries ``# EXPECT[ZLxxx]``
  markers on the lines that MUST be flagged, and the analyzer's open
  findings equal the markers EXACTLY, so the correct-idiom functions
  double as negative cases;
* per-rule coverage -- each rule has a positive marker and a clean
  function in its fixture file;
* suppression semantics -- the port's ``# zenlint-torch:`` directive:
  trailing and standalone, the mandatory ``-- reason``, wrong-rule ids,
  several rules in one directive, docstring mentions, stale directives;
* the CLI gate -- exit codes 0/1/2, the rule filter, the formats, the
  seeded violation file, and the strict gate over ``src/repro_torch``
  and ``chip_smoke.py``.

Held against the reference: the port's analyzer over each of the
reference's fixtures (its directive word substituted) gives the
reference analyzer's ZL000, ZL001 and ZL005 findings, line for line.
"""

import ast
import io
import json
import re
import tokenize
from pathlib import Path

import pytest

from repro.analysis import analyze_source as jax_analyze_source
from repro_torch.analysis import analyze_source
from repro_torch.analysis.__main__ import _gh_escape
from repro_torch.analysis.__main__ import main as zenlint_main
from repro_torch.analysis.engine import ENGINE_RULE

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "zenlint_torch_fixtures"
JAX_FIXTURES = Path(__file__).resolve().parent / "zenlint_fixtures"
RULE_IDS = ["ZL001", "ZL002", "ZL003", "ZL004", "ZL005"]
SHARED_RULES = {ENGINE_RULE, "ZL001", "ZL005"}

_EXPECT = re.compile(r"#\s*EXPECT\[([A-Z0-9,\s]+)\]")

#: a minimal ZL001 violation; ``{}`` takes the trailing comment
VIOLATION = "def free_view_ids(pool, req):\n    pool._give(req.pages){}\n"
DIRECTIVE = "# zenlint-torch: ignore"


def expected_findings(source):
    """{(line, rule)} from the EXPECT markers (tokenized, not regexed
    over raw lines, for the same docstring-safety the analyzer has)."""
    out = set()
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.COMMENT:
            m = _EXPECT.search(tok.string)
            if m:
                for rule in m.group(1).split(","):
                    out.add((tok.start[0], rule.strip()))
    return out


def fixture_source(rule_id):
    (path,) = FIXTURES.glob(f"{rule_id.lower()}_*.py")
    return path.read_text()


# ---------------------------------------------------------------------------
# fixture cross-check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "name", sorted(p.name for p in FIXTURES.glob("*.py")
                   if p.name != "__init__.py"))
def test_fixture_findings_match_markers_exactly(name):
    source = (FIXTURES / name).read_text()
    expected = expected_findings(source)
    findings = analyze_source(source, path=name)
    actual = {(f.line, f.rule) for f in findings if not f.suppressed}
    assert actual == expected, (
        f"missed: {sorted(expected - actual)}; "
        f"false positives: {sorted(actual - expected)}")
    assert expected, f"{name} carries no positive cases"
    assert not [f for f in findings if f.suppressed]


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_each_rule_has_positive_and_negative_fixtures(rule_id):
    source = fixture_source(rule_id)
    expected = expected_findings(source)
    assert any(rule == rule_id for _, rule in expected), (
        f"no positive fixture for {rule_id}")
    flagged = {line for line, _ in expected}
    funcs = [n for n in ast.walk(ast.parse(source))
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n.name != "__init__"]
    clean = [f.name for f in funcs
             if not any(f.lineno <= line <= f.end_lineno
                        for line in flagged)]
    assert clean, f"no negative (clean) fixture function for {rule_id}"


# ---------------------------------------------------------------------------
# suppression semantics
# ---------------------------------------------------------------------------

def test_trailing_suppression_with_reason_suppresses():
    src = VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- test reason")
    (finding,) = analyze_source(src)
    assert finding.rule == "ZL001"
    assert finding.suppressed and finding.reason == "test reason"


def test_standalone_suppression_covers_next_code_line():
    src = ("def f(pool, req):\n"
           f"    {DIRECTIVE}[ZL001] -- justification prose that\n"
           "    # continues on a second comment line\n"
           "\n"
           "    pool._give(req.pages)\n")
    (finding,) = analyze_source(src)
    assert finding.suppressed
    assert "justification prose" in finding.reason


def test_reasonless_suppression_is_flagged_and_does_not_suppress():
    findings = analyze_source(VIOLATION.format(f"  {DIRECTIVE}[ZL001]"))
    assert sorted(f.rule for f in findings) == [ENGINE_RULE, "ZL001"]
    assert all(not f.suppressed for f in findings)


def test_wrong_rule_id_does_not_suppress():
    src = VIOLATION.format(f"  {DIRECTIVE}[ZL004] -- wrong rule")
    assert [f for f in analyze_source(src)
            if f.rule == "ZL001" and not f.suppressed]


def test_multi_rule_directive_suppresses_each_listed_rule():
    src = VIOLATION.format(f"  {DIRECTIVE}[ZL001, ZL004] -- both listed")
    (finding,) = analyze_source(src)
    assert finding.suppressed


def test_directive_mentioned_in_docstring_is_not_a_directive():
    src = ('def f(pool, req):\n'
           f'    """prose mentioning {DIRECTIVE}[ZL001] only."""\n'
           '    pool._give(req.pages)\n')
    findings = analyze_source(src)
    assert [f.rule for f in findings] == ["ZL001"]
    assert not findings[0].suppressed


@pytest.mark.parametrize("word", ["zenlint", "zenlint-jax", "zenlint_torch"])
def test_only_the_port_directive_word_suppresses(word):
    """The reference's word (and near misses) suppress nothing here --
    so a port file's directive cannot go stale under the reference's
    strict gate, and a reference directive is not honoured here."""
    src = VIOLATION.format(f"  # {word}: ignore[ZL001] -- why")
    assert [(f.rule, f.suppressed) for f in analyze_source(src)] == [
        ("ZL001", False)]


def test_port_directive_is_invisible_to_the_reference():
    src = VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- why")
    assert [(f.rule, f.suppressed) for f in jax_analyze_source(
        src, strict_suppressions=True)] == [("ZL001", False)]


def test_parse_error_is_an_engine_finding():
    (finding,) = analyze_source("def broken(:\n")
    assert finding.rule == ENGINE_RULE
    assert "parse error" in finding.message


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------

def test_cli_clean_file_exits_zero(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert zenlint_main([str(clean)]) == 0
    assert "zenlint: OK" in capsys.readouterr().out


def test_cli_violation_exits_one_and_reports(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(VIOLATION.format(""))
    assert zenlint_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "ZL001" in out and "zenlint: FAIL" in out


def test_cli_suppressed_finding_passes_but_is_counted(tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text(VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- why"))
    assert zenlint_main([str(ok)]) == 0
    assert "1 suppressed" in capsys.readouterr().out


def test_cli_rule_filter_limits_rules(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(VIOLATION.format(""))
    assert zenlint_main(["--rule", "ZL004", str(bad)]) == 0
    assert zenlint_main(["--rule", "ZL001", str(bad)]) == 1


def test_cli_unknown_rule_exits_two(capsys):
    assert zenlint_main(["--rule", "ZL999", "unused"]) == 2
    assert "ZL999" in capsys.readouterr().err


def test_cli_bad_usage_exits_two(capsys):
    with pytest.raises(SystemExit) as e:
        zenlint_main(["--format", "xml", "unused"])
    assert e.value.code == 2
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert zenlint_main(["--list-rules", "unused"]) == 0
    out = capsys.readouterr().out
    for rule_id in RULE_IDS:
        assert rule_id in out


def test_cli_seeded_violation_fails_the_gate(capsys):
    """The gate's self-check: it MUST fail on the seeded file."""
    assert zenlint_main([str(FIXTURES / "seeded_violation.py")]) == 1
    out = capsys.readouterr().out
    assert "ZL001" in out and "ZL004" in out


def test_port_tree_is_gate_clean(capsys):
    """The port's gate: strict over the port and its chip script, every
    directive earning its keep and giving its reason."""
    paths = [str(REPO / "src" / "repro_torch"), str(REPO / "chip_smoke.py")]
    assert zenlint_main(["--strict-suppressions"] + paths) == 0, \
        capsys.readouterr().out


def test_cli_format_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(VIOLATION.format(""))
    assert zenlint_main(["--format", "json", str(bad)]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["open"] == 1 and doc["ok"] is False
    (f,) = doc["findings"]
    assert f["rule"] == "ZL001" and f["path"] == str(bad)
    ok = tmp_path / "ok.py"
    ok.write_text(VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- why"))
    assert zenlint_main(["--format", "json", str(ok)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["suppressed"] == 1
    assert doc["findings"][0]["reason"] == "why"


def test_cli_format_github(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(VIOLATION.format(""))
    assert zenlint_main(["--format", "github", str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"::error file={bad},line=" in out
    assert "title=zenlint ZL001::" in out
    ok = tmp_path / "ok.py"
    ok.write_text(VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- why"))
    assert zenlint_main(["--format", "github", "--show-suppressed",
                         str(ok)]) == 0
    out = capsys.readouterr().out
    assert "::notice" in out and "::error" not in out
    assert _gh_escape("a\nb%c") == "a%0Ab%25c"


def test_stale_suppression_flagged_only_in_strict_mode(tmp_path, capsys):
    f = tmp_path / "stale.py"
    f.write_text(f"x = 1  {DIRECTIVE}[ZL001] -- long-gone finding\n")
    assert zenlint_main([str(f)]) == 0
    capsys.readouterr()
    assert zenlint_main(["--strict-suppressions", str(f)]) == 1
    out = capsys.readouterr().out
    assert "stale suppression of [ZL001]" in out and ENGINE_RULE in out


def test_strict_mode_respects_rule_filter(tmp_path):
    f = tmp_path / "other.py"
    f.write_text(VIOLATION.format(f"  {DIRECTIVE}[ZL001] -- why"))
    assert zenlint_main(["--strict-suppressions", str(f)]) == 0
    assert zenlint_main(["--strict-suppressions", "--rule", "ZL004",
                         str(f)]) == 0


# ---------------------------------------------------------------------------
# held against the reference
# ---------------------------------------------------------------------------

def _shared(findings):
    return sorted((f.rule, f.line, f.suppressed, f.reason)
                  for f in findings if f.rule in SHARED_RULES)


@pytest.mark.parametrize(
    "name", sorted(p.name for p in JAX_FIXTURES.glob("*.py")
                   if p.name != "__init__.py"))
def test_reference_fixtures_give_the_reference_findings(name):
    """ZL000, ZL001 and ZL005 are the reference's rules: over the
    reference's own fixtures they find what the reference finds."""
    source = (JAX_FIXTURES / name).read_text()
    want = _shared(jax_analyze_source(source, path=name,
                                      strict_suppressions=True))
    got = _shared(analyze_source(
        source.replace("# zenlint: ignore", DIRECTIVE), path=name,
        strict_suppressions=True))
    assert got == want
    if name.startswith(("zl001", "zl005", "zl00x_interproc",
                        "zl00x_prefix")):
        assert want


@pytest.mark.parametrize("tail", [
    "", "  # zenlint: ignore[ZL001] -- why", "  # zenlint: ignore[ZL001]",
    "  # zenlint: ignore[ZL004] -- wrong rule",
    "  # zenlint: ignore[ZL001, ZL005] -- both"])
def test_directive_semantics_match_reference(tail):
    src = VIOLATION.format(tail) + "x = 1  # zenlint: ignore[ZL005] -- old\n"
    want = _shared(jax_analyze_source(src, strict_suppressions=True))
    got = _shared(analyze_source(src.replace("# zenlint: ignore", DIRECTIVE),
                                 strict_suppressions=True))
    assert got == want and want
