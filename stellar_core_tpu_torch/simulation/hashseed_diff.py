"""Hash-seed divergence differential: the dynamic proof of determinism.

Python's str/bytes hashing is randomized per process (PYTHONHASHSEED),
so any consensus-path dependence on set/dict hash order forks the
replicated state machine between two validators that happen to boot
with different seeds.  The determinism lint rules ban those shapes
statically; this harness proves the property end-to-end: it runs the
same campaign in paired subprocesses under two *different*
PYTHONHASHSEED values (the seed must be fixed before interpreter start,
hence subprocesses) and asserts the canonical consensus artifacts are
byte-identical:

  flagship  the 51-node partition-flap-heal chaos campaign — the
            campaign-global slot → ledger-hash table
  soroban   the Soroban mixed classic/contract campaign — per-ledger
            bucket-list hashes plus the serial-vs-parallel identity bit

Both children run with the detguard runtime sanitizer armed
(STPU_DETGUARD=1): a wall-clock read, unseeded RNG draw, or str/bytes
hash() inside a guarded consensus region fail-stops the child, so a
green differential also certifies zero guard trips over the whole
campaign.

The port's copy: its children run this package
(``-m stellar_core_tpu_torch.simulation.hashseed_diff --child``), whose
detguard trips on this package's frames, and import no jax.  Besides the
reference's report, each child's wall time and its count of host
signature verifies (``crypto.verify.recompute``) are kept, outside the
compared payload, under ``children``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from ..util.clock import monotonic_now

# two arbitrary, distinct seeds: any consensus hash-order dependence
# shows up as a payload diff between them
DEFAULT_SEEDS = (0, 424242)
DEFAULT_FLAGSHIP_ORGS = 17      # 17 orgs x 3 validators = 51 nodes
DEFAULT_SOROBAN_LEDGERS = 50
CAMPAIGNS = ("flagship", "soroban")

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# child mode: run one campaign, emit canonical JSON
# ---------------------------------------------------------------------------

def _campaign_payload(campaign: str, orgs: int, ledgers: int) -> dict:
    import logging
    logging.getLogger("stellar").setLevel(logging.ERROR)
    if campaign == "flagship":
        from . import chaos
        res = chaos.run_scenario(
            chaos.scenario_partition_flap_heal(n_orgs=orgs))
        return {
            "campaign": "flagship",
            "passed": bool(res.passed),
            "nodes": orgs * 3,
            "slot_hashes": {str(s): h.hex()
                            for s, h in sorted(res.slot_hashes.items())},
        }
    if campaign == "soroban":
        from .loadgen import SorobanMixCampaign
        res = SorobanMixCampaign().run(n_ledgers=ledgers)
        return {
            "campaign": "soroban",
            "passed": bool(res["hashes_identical"]),
            "ledgers": int(res["ledgers"]),
            "applied": int(res["applied"]),
            "bucket_hashes": [h.hex() if isinstance(h, (bytes, bytearray))
                              else str(h) for h in res["bucket_hashes"]],
        }
    raise ValueError(f"unknown campaign {campaign!r}")


def _run_child(campaign: str, orgs: int, ledgers: int, out: str) -> None:
    from ..util import detguard
    from ..util.metrics import registry
    t0 = monotonic_now()
    payload = _campaign_payload(campaign, orgs, ledgers)
    doc = {
        "payload": payload,
        "hashseed": os.environ.get("PYTHONHASHSEED", ""),
        "detguard": {"armed": detguard.enabled(), **detguard.stats()},
        "wall_s": monotonic_now() - t0,
        "verify_recompute":
            registry().counter("crypto.verify.recompute").value,
    }
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# parent mode: paired subprocesses under distinct hash seeds
# ---------------------------------------------------------------------------

def _spawn(campaign: str, seed: int, orgs: int, ledgers: int,
           out: str) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONHASHSEED"] = str(seed)
    env["STPU_DETGUARD"] = "1"
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "stellar_core_tpu_torch.simulation.hashseed_diff",
         "--child", "--campaign", campaign, "--orgs", str(orgs),
         "--ledgers", str(ledgers), "--out", out],
        cwd=_REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _first_divergence(a: dict, b: dict) -> Optional[str]:
    if a == b:
        return None
    table_key = "slot_hashes" if "slot_hashes" in a else "bucket_hashes"
    ta, tb = a.get(table_key), b.get(table_key)
    if isinstance(ta, dict) and isinstance(tb, dict):
        for slot in sorted(set(ta) | set(tb), key=int):
            if ta.get(slot) != tb.get(slot):
                return (f"{table_key}[{slot}]: "
                        f"{ta.get(slot)} != {tb.get(slot)}")
    elif isinstance(ta, list) and isinstance(tb, list):
        for i, (x, y) in enumerate(zip(ta, tb)):
            if x != y:
                return f"{table_key}[{i}]: {x} != {y}"
        if len(ta) != len(tb):
            return f"{table_key} length: {len(ta)} != {len(tb)}"
    return "payloads differ outside the hash table"


def run_pair(campaign: str,
             seeds: Tuple[int, int] = DEFAULT_SEEDS,
             orgs: int = DEFAULT_FLAGSHIP_ORGS,
             ledgers: int = DEFAULT_SOROBAN_LEDGERS,
             timeout_s: float = 900.0) -> dict:
    """Run `campaign` under both hash seeds concurrently and compare the
    canonical payloads byte-for-byte.  Returns a report dict; raises
    nothing — failures are encoded in the report (``ok`` False)."""
    t0 = monotonic_now()
    outs, procs = [], []
    for seed in seeds:
        fd, path = tempfile.mkstemp(
            prefix=f"hashseed-{campaign}-{seed}-", suffix=".json")
        os.close(fd)
        outs.append(path)
        procs.append(_spawn(campaign, seed, orgs, ledgers, path))
    errors: List[str] = []
    docs: List[Optional[dict]] = []
    for seed, proc, path in zip(seeds, procs, outs):
        try:
            _, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"seed {seed}: timeout after {timeout_s:.0f}s")
            docs.append(None)
            continue
        if proc.returncode != 0:
            tail = err.decode("utf-8", "replace").strip().splitlines()[-3:]
            errors.append(f"seed {seed}: exit {proc.returncode}: "
                          + " | ".join(tail))
            docs.append(None)
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                docs.append(json.load(f))
        except (OSError, ValueError) as e:
            errors.append(f"seed {seed}: unreadable payload: {e}")
            docs.append(None)
    for path in outs:
        try:
            os.unlink(path)
        except OSError:
            pass
    report = {
        "campaign": campaign,
        "seeds": list(seeds),
        "wall_s": monotonic_now() - t0,
        "errors": errors,
        "ok": False,
        "identical": False,
        "divergence": None,
        "detguard": [],
        "children": [],
    }
    if any(d is None for d in docs):
        return report
    payloads = [d["payload"] for d in docs]
    report["detguard"] = [d["detguard"] for d in docs]
    report["children"] = [{"seed": seed, "wall_s": d["wall_s"],
                           "verify_recompute": d["verify_recompute"]}
                          for seed, d in zip(seeds, docs)]
    report["divergence"] = _first_divergence(payloads[0], payloads[1])
    report["identical"] = report["divergence"] is None
    campaign_passed = all(p.get("passed") for p in payloads)
    guard_ok = all(g["armed"] and g["trips"] == 0 and g["regions"] > 0
                   for g in report["detguard"])
    if not campaign_passed:
        report["errors"].append("campaign reported failure in a child")
    if not guard_ok:
        report["errors"].append(
            "detguard not armed, no regions entered, or trips > 0: "
            + json.dumps(report["detguard"]))
    report["ok"] = report["identical"] and campaign_passed and guard_ok
    return report


def run_all(seeds: Tuple[int, int] = DEFAULT_SEEDS,
            orgs: int = DEFAULT_FLAGSHIP_ORGS,
            ledgers: int = DEFAULT_SOROBAN_LEDGERS,
            timeout_s: float = 900.0) -> List[dict]:
    return [run_pair(c, seeds=seeds, orgs=orgs, ledgers=ledgers,
                     timeout_s=timeout_s) for c in CAMPAIGNS]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stellar_core_tpu_torch.simulation.hashseed_diff",
        description="paired-subprocess PYTHONHASHSEED divergence check")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--campaign", choices=CAMPAIGNS, default=None)
    ap.add_argument("--orgs", type=int, default=DEFAULT_FLAGSHIP_ORGS)
    ap.add_argument("--ledgers", type=int, default=DEFAULT_SOROBAN_LEDGERS)
    ap.add_argument("--seeds", type=int, nargs=2, default=DEFAULT_SEEDS,
                    metavar=("A", "B"))
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        _run_child(args.campaign, args.orgs, args.ledgers, args.out)
        return 0

    campaigns = [args.campaign] if args.campaign else list(CAMPAIGNS)
    rc = 0
    for campaign in campaigns:
        rep = run_pair(campaign, seeds=tuple(args.seeds), orgs=args.orgs,
                       ledgers=args.ledgers, timeout_s=args.timeout)
        guard = rep["detguard"] or [{"regions": 0, "trips": "?"}] * 2
        status = "IDENTICAL" if rep["ok"] else "DIVERGED/FAILED"
        print(f"hashseed-diff [{campaign}] seeds={rep['seeds']} "
              f"{status} wall={rep['wall_s']:.1f}s "
              f"regions={[g.get('regions') for g in guard]} "
              f"trips={[g.get('trips') for g in guard]}")
        if rep["divergence"]:
            print(f"  first divergence: {rep['divergence']}")
        for e in rep["errors"]:
            print(f"  error: {e}")
        if not rep["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
