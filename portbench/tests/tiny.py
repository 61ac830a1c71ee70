"""Tiny cells for the CPU tests: each configuration cut to a few hundred
accounts and a few seconds, the port on its plain versions."""

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def cell(workload: str, mix: dict = None, catchup: dict = None,
         **archive) -> dict:
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    cfg = json.loads((BENCH / "configs" / f"{w['config']}.json")
                     .read_text())
    overrides = mix or {}
    mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json").read_text())
    cfg = copy.deepcopy(cfg)
    if cfg["runner"] == "catchup":
        cfg["archive"].update(accounts=200, txs_per_ledger=12,
                              payment_ledgers=4, corrupt_every=7,
                              **archive)
        cfg["catchup"].update(catchup or {})
    else:
        cfg.update(accounts=300, ledger_s=1)
        cfg["node"]["ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING"] = True
        # the card's machine has no libsodium, so the node closes on its
        # Python path there; hold this machine to the same path
        cfg["node"]["NATIVE_CLOSE"] = "off"
        mix.update(rate_tx_s=10, corrupt_every=5)
    mix.update(overrides)
    return {"workload": w, "config": cfg, "mix": mix}


def within(fn, seconds: float = 60.0):
    """fn()'s result, or the test fails where it has not returned within
    `seconds` (a runner whose window never closes would hang the run)."""
    import threading
    import pytest
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test's thread
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{fn.__qualname__} did not return within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def engine_or_skip(native: bool) -> None:
    """Skip a case of the native apply engine where it does not load."""
    if native:
        import pytest
        from stellar_core_tpu_torch.ledger.native_apply import (
            native_apply_available)
        if not native_apply_available():
            pytest.skip("the native apply engine or libsodium does not "
                        "load here")
