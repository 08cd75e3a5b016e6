"""svmlint of the port — source-level contract checking for the engine
invariants, its scoped rules keyed on ``repro_torch`` (a copy of
``repro.analysis``, whose scopes name ``repro``).

Public surface::

    from repro_torch.analysis import lint_paths, lint_source, RULES
    findings = lint_paths(["src/repro_torch"])   # [] on a clean tree

and the CLI ``python -m repro_torch.analysis [paths]``

plus the runtime frozen-column audit (`assert_frozen`,
`frozen_violations`).  Importing the package registers the contract
rules from `repro_torch.analysis.rules`.
"""

from repro_torch.analysis.core import (
    Finding,
    LintModule,
    Rule,
    RULES,
    SUPPRESSION_RULE,
    iter_py_files,
    lint_paths,
    lint_source,
    register_rule,
)
from repro_torch.analysis import rules as _rules  # noqa: F401  (registers rules)
from repro_torch.analysis.rules import (
    ATTRIBUTION_COUNTERS,
    COLUMN_FIELDS,
    MANAGER_DRIVE,
    opcode_universe,
)
from repro_torch.analysis.runtime import assert_frozen, frozen_violations

__all__ = [
    "Finding",
    "LintModule",
    "Rule",
    "RULES",
    "SUPPRESSION_RULE",
    "iter_py_files",
    "lint_paths",
    "lint_source",
    "register_rule",
    "ATTRIBUTION_COUNTERS",
    "COLUMN_FIELDS",
    "MANAGER_DRIVE",
    "opcode_universe",
    "assert_frozen",
    "frozen_violations",
]
