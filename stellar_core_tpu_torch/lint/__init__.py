"""corelint — project-native static analysis for the PyTorch / CUDA port.

The reference package's corelint, retargeted at this package's tree: every
path a rule names (consensus scope, exempt and allowed files) is this
package's, and the default targets are the package, chip_smoke.py and the
shared native/*.c sources.

Encodes the repo's cross-PR invariants as AST checks (see rules/):

  clock-discipline   VirtualClock-only time outside util/clock, util/perf
  ledger-txn-paths   every LedgerTxn reaches commit()/rollback()
  decode-free-seam   the raw-record path never rehydrates BucketEntry
  exception-hygiene  no silently swallowed `except Exception`
  metric-registry    static layer.subsystem.event + canonical-list check
  lock-order         cycle-free static lock-acquisition graph
  thread-safety      cross-thread fields lock-guarded or owned-by annotated
  raw-lock           threading.Lock/RLock only via util.lockorder.make_lock
  iteration-order    no set/dict-view iteration into order-sensitive sinks
                     (XDR, hashing, escaping lists, broadcast) unsorted
  float-discipline   no floats/true division on protocol-visible values
  hash-order         no builtin hash() / id()-keyed ordering in consensus
  rng-discipline     randomness only via an injected seeded random.Random

Run `python -m stellar_core_tpu_torch.lint` from the repo root; suppress a
finding with `# corelint: disable=<rule> -- reason` — suppressions are
ratcheted by stellar_core_tpu_torch/lint/LINT_BASELINE.json (`--baseline`).
The thread-safety rule's runtime twin is util/racetrace.py
(STPU_RACE_TRACE=1); the determinism rules' runtime twin is
util/detguard.py (STPU_DETGUARD=1) and their differential proof is
simulation/hashseed_diff.py.
"""

from .core import (FileContext, LintReport, Rule, Violation,  # noqa: F401
                   check_baseline, load_baseline, render_human,
                   render_json, run_paths, write_baseline)
from .rules import ALL_RULE_CLASSES, all_rules, rules_by_id  # noqa: F401

DEFAULT_TARGETS = ("stellar_core_tpu_torch", "chip_smoke.py", "native")
