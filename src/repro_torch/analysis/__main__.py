"""svmlint CLI of the port — contract-checking static analysis over
``src/repro_torch``.

Usage::

    python -m repro_torch.analysis                  # lint src/repro_torch
    python -m repro_torch.analysis --list-rules     # show registered rules
    python -m repro_torch.analysis --rules determinism src/repro_torch/svm

Exits 1 on any finding, 2 on an unknown rule name.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import RULES, lint_paths

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="check the engine's equivalence contracts at the "
                    "source level")
    ap.add_argument("paths", nargs="*", default=[_PACKAGE],
                    help="files or directories to lint "
                         "(default: the repro_torch package)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list registered rules and exit")
    ap.add_argument("--rules", metavar="NAME[,NAME...]",
                    help="run only the named rules")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(name) for name in RULES)
        for name in sorted(RULES):
            rule = RULES[name]
            scope = ", ".join(rule.scope) if rule.scope else "repro_torch"
            print(f"{name:<{width}}  [{scope}]  {rule.doc}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        findings = lint_paths(args.paths, rules=rules)
    except KeyError as exc:
        print(f"svmlint: {exc.args[0]}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.format())
    n = len(findings)
    print(f"svmlint: {n} finding{'s' if n != 1 else ''} "
          f"({len(RULES)} rules)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
