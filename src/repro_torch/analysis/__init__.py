"""Reprolint — determinism/invariant static analysis (DESIGN.md §14), a
copy of the reference's stdlib-only `src/repro/analysis/` with its rules
R001-R006 as they are (R005 and R006 look at JAX code).

Run it as ``python -m repro_torch.analysis src/repro_torch``. The
companion RUNTIME checker — the metro-engine sanitizer — lives in
`repro_torch.metro.sanitizer` and is enabled per run via
``MetroEngine.run(sanitize=True)``.
"""
from repro_torch.analysis.linter import (FileContext, Finding, Rule,
                                         lint_file, lint_paths)
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

__all__ = ["ALL_RULES", "RULES_BY_ID", "FileContext", "Finding", "Rule",
           "lint_file", "lint_paths"]
