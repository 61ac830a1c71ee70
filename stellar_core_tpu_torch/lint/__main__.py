"""corelint CLI: `python -m stellar_core_tpu_torch.lint [paths...]`.

Exit status: 0 clean (all findings suppressed and within the baseline),
1 violations or suppression-ratchet growth, 2 usage errors.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (DEFAULT_TARGETS, all_rules, check_baseline, load_baseline,
               render_human, render_json, rules_by_id, run_paths,
               write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stellar_core_tpu_torch.lint",
        description="corelint: project-native static analysis")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_TARGETS})")
    ap.add_argument("--json", action="store_true",
                    help="emit the JSON report instead of human output")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="suppression-ratchet file to enforce")
    ap.add_argument("--write-baseline", default=None, metavar="FILE",
                    help="write the current suppression set as the "
                         "new baseline and exit")
    ap.add_argument("--root", default=None,
                    help="repo root for relative paths (default: cwd)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="list suppressed findings in human output")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:18s} {r.description}")
        return 0

    try:
        rules = rules_by_id(args.rules.split(",")) if args.rules \
            else all_rules()
    except KeyError as e:
        print(f"corelint: {e}", file=sys.stderr)
        return 2

    nondefault_root = args.root is not None \
        and os.path.abspath(args.root) != os.getcwd()
    if (args.baseline or args.write_baseline) \
            and (args.rules or args.paths or nondefault_root):
        # the suppression baseline is defined over the FULL default scope
        # keyed by cwd-relative paths; a partial run or a different
        # --root would fail a clean tree (or write mis-keyed entries
        # that fail every run after)
        print("corelint: --baseline/--write-baseline require the default "
              "full scope (no --rules, no explicit paths, no --root)",
              file=sys.stderr)
        return 2

    missing = [p for p in (args.paths or []) if not os.path.exists(p)]
    if missing:
        # a typo'd CI path must not lint zero files and report green
        print(f"corelint: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    targets = args.paths or [p for p in DEFAULT_TARGETS if os.path.exists(p)]
    if not targets:
        print("corelint: no lint targets found", file=sys.stderr)
        return 2
    report = run_paths(targets, rules, root=args.root)

    if args.write_baseline:
        write_baseline(args.write_baseline, report)
        print(f"corelint: wrote baseline "
              f"({len(report.suppression_counts())} suppression keys) "
              f"to {args.write_baseline}")
        if report.violations or report.parse_errors:
            # the baseline only covers suppressions — live violations
            # must not hide behind a green-looking regen
            print(render_human(report))
            return 1
        return 0

    failures = len(report.violations) > 0 or bool(report.parse_errors)
    ratchet_problems = []
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"corelint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        ratchet_problems = check_baseline(report, baseline)
        failures = failures or bool(ratchet_problems)

    if args.json:
        print(render_json(report))
    else:
        print(render_human(report, verbose_suppressed=args.show_suppressed))
    for p in ratchet_problems:
        print(p, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
