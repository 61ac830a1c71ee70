"""The port's fleet, fuzzers, apply-load and the 24 subcommands that came
with them, against the reference where both compute the same thing.

The reference's own tests of these modules run on both packages in
test_torch_fleet_mirror.py, test_torch_chaos_mirror.py and
test_torch_node_mirror.py; these check what the port must keep equal
outside them (the fuzzers' random sequence, apply-load's ledger hash) and
what it changes: the fleet's processes run the port's package, and with
no card and no STPU_ACCEL its nodes refuse to start (there is no CPU
fallback).  Every subcommand of the reference's command line runs through
``python -m stellar_core_tpu_torch`` with STPU_ACCEL=none.
"""

from __future__ import annotations

import gzip
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import pytest
import torch

from stellar_core_tpu import xdr as RX
from stellar_core_tpu import fuzz as rfuzz
from stellar_core_tpu.main import commandline as rcli
from stellar_core_tpu.simulation.apply_load import ApplyLoad as RApplyLoad
from stellar_core_tpu_torch import fuzz, xdr as X
from stellar_core_tpu_torch.main import commandline as cli
from stellar_core_tpu_torch.simulation.apply_load import ApplyLoad
from stellar_core_tpu_torch.simulation.fleet import Fleet

ROOT = Path(__file__).resolve().parent.parent


def _encoded(cls, seed: int, make) -> tuple:
    """random_xdr_value(cls, Random(seed)) in XDR, or the error encoding
    raised (gen-fuzz skips those)."""
    try:
        return ("ok", make(cls, random.Random(seed)).to_xdr())
    except Exception as e:       # compared between the two packages
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("name", ["TransactionEnvelope", "StellarMessage"])
def test_random_xdr_values_are_the_references(name):
    """For 200 seeds the port's generator draws the reference's random
    sequence: the same value, the same bytes."""
    for seed in range(200):
        got = _encoded(getattr(X, name), seed, fuzz.random_xdr_value)
        want = _encoded(getattr(RX, name), seed, rfuzz.random_xdr_value)
        assert got == want, (name, seed)


def test_mutate_bytes_is_the_references():
    blob = bytes(range(200))
    for seed in range(50):
        assert fuzz.mutate_bytes(blob, random.Random(seed)) \
            == rfuzz.mutate_bytes(blob, random.Random(seed))


@pytest.mark.parametrize("mode", ["tx", "overlay"])
def test_gen_fuzz_writes_the_references_corpus(tmp_path, mode, capsys):
    """`gen-fuzz --seed 5` writes the reference's corpus, file for file and
    byte for byte."""
    args = ["gen-fuzz", "--mode", mode, "--count", "60", "--seed", "5"]
    assert cli.main(args + ["--output", str(tmp_path / "port")]) == 0
    assert rcli.main(args + ["--output", str(tmp_path / "ref")]) == 0
    port = sorted(os.listdir(tmp_path / "port"))
    assert port == sorted(os.listdir(tmp_path / "ref")) and len(port) > 30
    for name in port:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes(), name


def test_apply_load_ends_on_the_references_hash():
    got = ApplyLoad(n_accounts=200)
    report = got.run(5, 50)
    want = RApplyLoad(n_accounts=200)
    want.run(5, 50)
    assert got.mgr.last_closed_ledger_seq == want.mgr.last_closed_ledger_seq
    assert got.mgr.lcl_hash == want.mgr.lcl_hash
    assert (report["ledgers"], report["txs"]) == (5, 250)


def test_the_fleets_processes_run_the_port(tmp_path):
    """`run` and the rejoin's `catchup --parallel` start the port's
    package, never the reference's."""
    fleet = Fleet(str(tmp_path), n_nodes=2)
    fleet.provision()
    run = fleet._run_cmdline(fleet.nodes[0])
    assert " -m stellar_core_tpu_torch run --conf " in run
    started = []
    fleet.pm.run_command = lambda cmd, *a, **kw: started.append(cmd)
    fleet.start_catchup(1, 2)
    (catchup,) = started
    assert " -m stellar_core_tpu_torch catchup --conf " in catchup
    assert catchup.endswith("--parallel 2")
    # the configs name no ACCEL: the nodes take the port's default
    for node in fleet.nodes:
        assert "ACCEL" not in node.config
        assert not re.search(r"^ACCEL\b", Path(node.conf_path).read_text(),
                             re.M)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a machine without a CUDA card")
def test_a_fleet_without_a_card_fails_at_boot(tmp_path, monkeypatch):
    """With no card and STPU_ACCEL unset every node takes ACCEL "cuda",
    refuses to start, and the fleet fails at boot: no CPU fallback."""
    monkeypatch.delenv("STPU_ACCEL", raising=False)
    fleet = Fleet(str(tmp_path), n_nodes=2)
    fleet.provision()
    try:
        fleet.start()
        with pytest.raises(RuntimeError, match="died during boot"):
            fleet.wait_all_healthy(timeout_s=120.0)
        # the first death ends the boot; the others end on their own
        deadline = time.monotonic() + 120.0
        while any(n.proc_ev.exit_code is None for n in fleet.nodes) \
                and time.monotonic() < deadline:
            fleet.crank()
            time.sleep(0.1)
    finally:
        fleet.teardown()
    for node in fleet.nodes:
        assert node.proc_ev.exit_code == 1
        assert "run: no CUDA device" in Path(node.log_path).read_text()
        assert all(state != "ok" for _, state in node.health_timeline)


# -- every subcommand through `python -m stellar_core_tpu_torch` -------------

def _subcommands(main) -> list:
    """The subcommands main()'s parser declares (read off its
    add_parser calls)."""
    import inspect
    return re.findall(r'add_parser\(\s*"([a-z-]+)"', inspect.getsource(main))


NEW_COMMANDS = ("publish", "new-hist", "self-check", "verify-checkpoints",
                "report-last-history-checkpoint", "offline-info",
                "print-xdr", "dump-xdr", "tsdump", "dump-ledger",
                "diag-bucket-stats", "encode-asset", "sign-transaction",
                "convert-id", "http-command", "health", "fuzz", "gen-fuzz",
                "apply-load", "fleet", "test", "sec-to-pub", "gen-seed",
                "version")


def test_help_lists_every_subcommand_of_the_reference():
    ref = _subcommands(rcli.main)
    assert len(ref) == 29 and set(NEW_COMMANDS) <= set(ref)
    assert sorted(_subcommands(cli.main)) == sorted(ref)
    r = subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch",
                        "--help"], capture_output=True, text=True, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    listed = r.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert sorted(listed) == sorted(ref)


class _Ok(BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({"status": "ok", "path": self.path}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


PASSPHRASE = "port cli net"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A node's config (DATABASE, buckets, a local HISTORY archive, the
    HTTP port of a stub admin server that answers ok), its genesis
    database, an archive published by the port's LoadGenerator, a signed
    envelope alone and twice in a record-marked stream, a time-series
    dump and a fleet schedule."""
    from stellar_core_tpu_torch.history.archive import (FileHistoryArchive,
                                                        pack_xdr_stream)
    from stellar_core_tpu_torch.history.manager import HistoryManager
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.simulation import LoadGenerator
    from stellar_core_tpu_torch.testutils import (build_tx,
                                                  native_payment_op,
                                                  network_id)
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.util.timeseries import TimeSeriesStore
    from stellar_core_tpu_torch.util import metrics

    d = tmp_path_factory.mktemp("cli")
    server = HTTPServer(("127.0.0.1", 0), _Ok)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    conf = d / "node.cfg"
    conf.write_text(f'NETWORK_PASSPHRASE = "{PASSPHRASE}"\n'
                    f'DATABASE = "{d}/node.db"\n'
                    f'BUCKET_DIR_PATH = "{d}/buckets"\n'
                    f"HTTP_PORT = {server.server_address[1]}\n"
                    f'\n[HISTORY.local]\nget = "{d}/arch"\nput = "{d}/arch"\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(STPU_ACCEL="none", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch",
                        "new-db", "--conf", str(conf)], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=180)
    assert r.returncode == 0, r.stderr
    mgr = LedgerManager(network_id(PASSPHRASE))
    mgr.start_new_ledger()
    hm = HistoryManager(mgr, PASSPHRASE,
                        [FileHistoryArchive(str(d / "published"))])
    gen = LoadGenerator(mgr, hm, seed=9)
    gen.create_accounts(6, per_ledger=6)
    gen.payment_ledgers(3, txs_per_ledger=3)
    gen.run_to_checkpoint_boundary()
    sk = SecretKey(b"\x11" * 32)
    frame = build_tx(network_id(PASSPHRASE), sk, 1, [native_payment_op(
        X.AccountID.ed25519(b"\x22" * 32), 5)])
    (d / "tx.xdr").write_bytes(frame.envelope.to_xdr())
    blob = frame.envelope.to_xdr()
    (d / "txs.xdr.gz").write_bytes(gzip.compress(
        pack_xdr_stream([blob, blob])))
    metrics.reset_registry()
    store = TimeSeriesStore(cadence_s=1.0)
    metrics.registry().timer("ledger.ledger.close").update(0.01)
    store.capture()
    store.dump(str(d / "ts.json"))
    (d / "schedule.json").write_text(json.dumps(
        [{"kind": "traffic", "rate_per_s": 4.0},
         {"kind": "wait-ledger", "seq": 4}]))
    yield {"dir": d, "conf": str(conf), "env": env,
           "tip": (mgr.last_closed_ledger_seq, mgr.lcl_hash.hex()),
           "seed": sk.to_strkey_seed(),
           "public": sk.public_key.to_strkey()}
    server.shutdown()


CASES = {
    "version": (lambda w: ["version"], "stellar-core-tpu-torch"),
    "sec-to-pub": (lambda w: ["sec-to-pub", w["seed"]], "{public}"),
    "gen-seed": (lambda w: ["gen-seed"], '"secret": "S'),
    "publish": (lambda w: ["publish", "--conf", w["conf"]],
                "published 0 queued checkpoint(s)"),
    "new-hist": (lambda w: ["new-hist", "--conf", w["conf"]],
                 "initialized archive at {dir}/arch"),
    "self-check": (lambda w: ["self-check", "--conf", w["conf"]],
                   '"ok": true'),
    "offline-info": (lambda w: ["offline-info", "--conf", w["conf"]],
                     '"num": 1'),
    "diag-bucket-stats": (lambda w: ["diag-bucket-stats", "--conf",
                                     w["conf"]], '"ledger": 1'),
    "dump-ledger": (lambda w: ["dump-ledger", "--conf", w["conf"],
                               "--limit", "1"], '"data"'),
    "verify-checkpoints": (lambda w: [
        "verify-checkpoints", "--archive", str(w["dir"] / "published")],
        "tip hash {tip_hash}"),
    "report-last-history-checkpoint": (lambda w: [
        "report-last-history-checkpoint", "--archive",
        str(w["dir"] / "published")], '"currentLedger": {tip_seq}'),
    "print-xdr": (lambda w: ["print-xdr", str(w["dir"] / "tx.xdr")],
                  '"type": "ENVELOPE_TYPE_TX"'),
    "dump-xdr": (lambda w: ["dump-xdr", str(w["dir"] / "txs.xdr.gz"),
                            "--filetype", "tx-envelope"],
                 '"type": "ENVELOPE_TYPE_TX"'),
    "tsdump": (lambda w: ["tsdump", str(w["dir"] / "ts.json")],
               '"metric": "ledger.ledger.close"'),
    "encode-asset": (lambda w: ["encode-asset"], "00000000"),
    "sign-transaction": (lambda w: ["sign-transaction",
                                    str(w["dir"] / "tx.xdr"),
                                    "--netid", PASSPHRASE], ""),
    "convert-id": (lambda w: ["convert-id", w["public"]], '"hex": '),
    "http-command": (lambda w: ["http-command", "info", "--conf",
                                w["conf"]], '"path": "/info"'),
    "health": (lambda w: ["health", "--conf", w["conf"]],
               '"status": "ok"'),
    "fuzz": (lambda w: ["fuzz", "--mode", "xdr", "--iters", "40"],
             "xdr fuzz: 40 cases, 0 findings"),
    "gen-fuzz": (lambda w: ["gen-fuzz", "--output", str(w["dir"] / "corpus"),
                            "--count", "5"], "corpus files to"),
    "apply-load": (lambda w: ["apply-load", "--accounts", "20",
                              "--ledgers", "2", "--txs", "5"],
                   '"ledgers": 2'),
    "fleet": (lambda w: ["fleet", "--nodes", "2", "--accounts", "4",
                         "--workdir", str(w["dir"] / "fleet"),
                         "--schedule", str(w["dir"] / "schedule.json"),
                         "--timeout", "120"], '"passed": true'),
    "test": (lambda w: ["test", "--", "-q", "-p", "no:cacheprovider",
                        "tests/test_torch_mirror.py", "-k",
                        "rewrite_points"], "1 passed"),
}


def test_the_cases_cover_the_new_subcommands():
    assert sorted(CASES) == sorted(NEW_COMMANDS)


@pytest.mark.parametrize("command", NEW_COMMANDS)
def test_each_new_subcommand_runs(workdir, command):
    make, expect = CASES[command]
    stdin = workdir["seed"] + "\n" if command == "sign-transaction" else None
    r = subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch",
                        *make(workdir)], capture_output=True, text=True,
                       cwd=ROOT, env=workdir["env"], input=stdin,
                       timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    expect = expect.format(public=workdir["public"], dir=workdir["dir"],
                           tip_seq=workdir["tip"][0],
                           tip_hash=workdir["tip"][1])
    assert expect in r.stdout, r.stdout[-2000:]
    if command == "sign-transaction":
        env = X.TransactionEnvelope.from_xdr(bytes.fromhex(r.stdout.strip()))
        # the fixture's envelope carried its source's signature already
        assert len(env.value.signatures) == 2
