"""The command-line gate: ``python -m repro_torch.analysis.cli
src/repro_torch``.

Text output is one ``path:line:col: rule-id: message`` line per active
finding; ``--json`` prints the whole report, suppressed findings included.
The exit status is 1 when any unsuppressed finding (stale suppressions
included) exists, else 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import __version__, checker, rules

__all__ = ["main"]


def _list_rules() -> str:
    width = max(len(r.id) for r in rules.RULES)
    lines = [f"repro_torch.analysis v{__version__} — rule catalog", ""]
    for rule in rules.RULES:
        lines.append(f"  {rule.id:<{width}}  {rule.summary}")
        lines.append(f"  {'':<{width}}  protects: {rule.protects}")
    lines += ["", "suppress with `# repro: ignore[rule-id]` on the flagged "
              "line, saying why (stale suppressions are themselves "
              "findings)"]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="AST checks of the port's invariants (stdlib only)")
    parser.add_argument("paths", nargs="*", metavar="PATH",
                        help="the repro_torch package directory, a "
                             "directory holding it, or a repository root")
    parser.add_argument("--json", action="store_true",
                        help="the whole report (suppressed findings "
                             "included) as JSON on stdout")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--version", action="version",
                        version=f"repro_torch.analysis {__version__}")
    args = parser.parse_args(argv)
    if args.list_rules:
        print(_list_rules())
        return 0
    if not args.paths:
        parser.error("at least one PATH is required (e.g. src/repro_torch)")

    findings: list[rules.Finding] = []
    for path in args.paths:
        findings.extend(checker.analyze(Path(path)))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    active = [f for f in findings if not f.suppressed]
    suppressed = len(findings) - len(active)
    if args.json:
        print(json.dumps({"version": __version__, "paths": list(args.paths),
                          "active": len(active), "suppressed": suppressed,
                          "findings": [f.to_json() for f in findings]},
                         indent=2))
    else:
        for finding in active:
            print(finding.render())
        print(f"repro_torch.analysis v{__version__}: {len(active)} "
              f"finding(s), {suppressed} suppressed", file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
