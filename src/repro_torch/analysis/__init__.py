"""zenlint and zensan over the port: the static analyzer and the runtime
sanitizer of the paged serving data plane.

The port's copy of ``repro/analysis``.  zenlint machine-checks the
conventions the type system cannot see -- view-local vs physical page
ids, aliases of device state a park rebinds, O(1)-capture bucketing,
sync-free hot paths, reclaim/regrant pairing -- at lint time::

    PYTHONPATH=src python -m repro_torch.analysis --strict-suppressions \\
        src/repro_torch chip_smoke.py

Programmatic surface: :func:`analyze_paths` / :func:`analyze_source`
return :class:`Finding` lists; ``rules.ALL_RULES`` is the registry.
Suppress a single finding with an inline justification::

    risky_line()   # zenlint-torch: ignore[ZL004] -- why this one is fine

zensan (:mod:`repro_torch.analysis.zensan`) checks the same data plane's
invariants at run time.  The analyzer runs on the standard library only.
"""

from repro_torch.analysis.engine import (Finding, Module, Rule,
                                         analyze_paths, analyze_source)

__all__ = ["Finding", "Module", "Rule", "analyze_paths", "analyze_source"]
