"""The port's node: `run` and `new-db`, the Application's accel settings,
in-process networks, and what the port changes in the copied modules.

The reference's own tests of the overlay and the application run on both
packages in test_torch_node_mirror.py; these check what differs: ACCEL
"cuda" (the default) refuses to start where there is no card, "cpu" puts
admission and catchup on the kernels' plain versions, "none" turns them
off, and STPU_ACCEL sets the default.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from stellar_core_tpu_torch.main.config import Config

ROOT = Path(__file__).resolve().parent.parent


def _cli(*args, env=None, timeout=180):
    return subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout, env=env)


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "STPU_ACCEL"}
    env.update(kw)
    return env


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("accel", ["cpu", "none"])
def test_new_db_on_the_cpu(tmp_path, accel):
    conf = tmp_path / "n.cfg"
    conf.write_text(f'DATABASE = "{tmp_path}/node.db"\nACCEL = "{accel}"\n')
    r = _cli("new-db", "--conf", str(conf), env=_env())
    assert r.returncode == 0, r.stderr
    assert "genesis ledger 1" in r.stdout
    assert (tmp_path / "node.db").exists()


@pytest.mark.parametrize("command", ["new-db", "run"])
@pytest.mark.parametrize("accel", ["", 'ACCEL = "cuda"\n'],
                         ids=["default", "cuda"])
def test_cuda_without_a_card_is_refused(tmp_path, command, accel):
    """Without a card, ACCEL "cuda" (the default) exits 1 before the node
    touches its database (new-db would delete it first) or opens a
    port."""
    (tmp_path / "node.db").write_bytes(b"an operator's database")
    conf = tmp_path / "n.cfg"
    conf.write_text(f'DATABASE = "{tmp_path}/node.db"\n'
                    f"HTTP_PORT = {_free_port()}\n{accel}")
    r = _cli(command, "--conf", str(conf), timeout=60,
             env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 1
    assert "CUDA" in r.stderr and "Traceback" not in r.stderr
    assert (tmp_path / "node.db").read_bytes() == b"an operator's database"


def test_tpu_is_refused(tmp_path):
    conf = tmp_path / "n.cfg"
    conf.write_text('ACCEL = "tpu"\n')
    r = _cli("new-db", "--conf", str(conf), env=_env())
    assert r.returncode != 0 and "tpu" in r.stderr


def test_stpu_accel_sets_the_default(monkeypatch):
    monkeypatch.delenv("STPU_ACCEL", raising=False)
    assert Config().ACCEL == "cuda"
    monkeypatch.setenv("STPU_ACCEL", "cpu")
    assert Config().ACCEL == "cpu"
    assert Config.from_dict({"ACCEL": "none"}).ACCEL == "none"
    assert Config().accel() == (True, "cpu")
    monkeypatch.setenv("STPU_ACCEL", "tpu")
    with pytest.raises(ValueError, match="tpu"):
        Config().accel()


def test_run_serves_a_node_on_the_plain_versions(tmp_path):
    """`run` with ACCEL "cpu": the node closes ledgers, answers /info and
    /tx (a payment is admitted), publishes to its archive,
    and exits 0 on SIGTERM."""
    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.testutils import build_tx, native_payment_op
    port = _free_port()
    conf = tmp_path / "node.toml"
    conf.write_text(
        'NETWORK_PASSPHRASE = "torch run test"\nRUN_STANDALONE = true\n'
        f'PEER_PORT = 0\nHTTP_PORT = {port}\nACCEL = "cpu"\n'
        "ACCEL_CHUNK_SIZE = 256\n"
        "ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING = true\n"
        f'DATABASE = "{tmp_path}/node.db"\n'
        f'[HISTORY.local]\nget = "{tmp_path}/arch"\nput = "{tmp_path}/arch"\n')
    proc = subprocess.Popen(
        [sys.executable, "-m", "stellar_core_tpu_torch", "run", "--conf",
         str(conf)], cwd=ROOT, env=_env(OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return json.loads(r.read())

    def ledger():
        return get("/info")["info"]["ledger"]["num"]

    try:
        deadline = time.monotonic() + 90
        seq = 0
        while seq < 2 and time.monotonic() < deadline:
            try:
                seq = ledger()
            except OSError:
                pass
            time.sleep(0.2)
        assert seq >= 2
        nid = hashlib.sha256(b"torch run test").digest()
        root = SecretKey(nid)
        tx = build_tx(nid, root, (1 << 32) + 1, [native_payment_op(
            X.AccountID.ed25519(root.public_key.ed25519), 5)])
        answer = get("/tx?blob=" + tx.envelope.to_xdr().hex())
        assert answer["status"] == "PENDING", answer
        while ledger() < 9 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert ledger() >= 9
        metrics = get("/metrics")["metrics"]["registry"]
        assert (tmp_path / "arch" / ".well-known"
                / "stellar-history.json").exists()
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert metrics["herder.admission.admitted"]["count"] >= 1, \
        {k: v for k, v in metrics.items() if "admission" in k}


def test_application_accel_settings(tmp_path, monkeypatch):
    """ACCEL decides where admission and catchup verify: "cpu" on the plain
    versions, "none" off; the back-pressure valve is wired to the
    overlay."""
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    monkeypatch.delenv("STPU_ACCEL", raising=False)
    for accel, on in (("cpu", True), ("none", False)):
        cfg = Config.from_dict({"NETWORK_PASSPHRASE": "torch app accel",
                                "RUN_STANDALONE": True, "PEER_PORT": 0,
                                "ACCEL": accel, "ACCEL_CHUNK_SIZE": 256})
        app = Application(cfg, VirtualClock(ClockMode.VIRTUAL_TIME),
                          listen=False)
        try:
            pipe = app.herder.admission
            assert pipe.accel == on and app.catchup.accel == on
            assert (app.accel, app.accel_device) == (on, "cpu" if on
                                                     else None)
            if on:
                assert pipe._preverify.devices == (torch.device("cpu"),)
                assert app.catchup.accel_device == "cpu"
            assert pipe.on_backpressure_release \
                == app.overlay.release_flood_grants
        finally:
            app.stop()


def test_application_refuses_cuda_without_a_card(monkeypatch):
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_dict({"RUN_STANDALONE": True, "PEER_PORT": 0,
                            "ACCEL": "cuda"})
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(cfg, VirtualClock(ClockMode.VIRTUAL_TIME), listen=False)


def test_simulation_takes_the_accel_settings(monkeypatch):
    """A Simulation's accel settings reach its nodes' admission (with the
    valve wired to their overlay) and their archive catchup."""
    from stellar_core_tpu_torch.catchup import catchup as catchup_mod
    from stellar_core_tpu_torch.simulation.simulation import \
        make_core_topology
    sim = make_core_topology(3)
    assert sim.accel is False and sim.accel_device is None
    sim.accel, sim.accel_device = True, "cpu"
    node = sim.nodes[0]
    node.enable_admission(batch_size=8, accel_chunk=256)
    try:
        pipe = node.herder.admission
        assert pipe.accel and pipe._preverify.devices == (
            torch.device("cpu"),)
        assert pipe.on_backpressure_release == \
            node.overlay.release_flood_grants
    finally:
        pipe.close()

    class Made(Exception):
        pass

    def made(*args, **kw):
        raise Made(kw)

    monkeypatch.setattr(catchup_mod, "CatchupManager", made)
    with pytest.raises(Made) as got:
        node.run_archive_catchup()
    kw = got.value.args[0]
    assert kw["accel"] is True and kw["accel_device"] == "cpu"


def test_sampleprof_buckets_the_ports_tree():
    from stellar_core_tpu_torch.util.sampleprof import _subsystem_of
    assert _subsystem_of("/x/stellar_core_tpu_torch/herder/a.py") == "herder"
    assert _subsystem_of("/x/stellar_core_tpu_torch/testutils.py") \
        == "testutils"
    assert _subsystem_of("/x/stellar_core_tpu/herder/a.py") == "other"


def test_overlay_constants_are_the_references():
    """A port node and a reference node handshake: the version string and
    the auth cert's prefix are the reference's, byte for byte."""
    from stellar_core_tpu.overlay import peer as r_peer
    from stellar_core_tpu.overlay import peer_auth as r_auth
    from stellar_core_tpu_torch.overlay import peer, peer_auth
    assert peer.VERSION_STR == r_peer.VERSION_STR
    assert peer_auth._CERT_PREFIX == r_auth._CERT_PREFIX


def test_a_port_node_handshakes_with_a_reference_node():
    """A loopback connection across the two packages, each side on its own
    package's overlay, peer and clock: the handshake authenticates both,
    and a transaction the port node floods reaches the reference node."""
    from stellar_core_tpu.crypto.keys import SecretKey as RSecret
    from stellar_core_tpu.herder.herder import Herder as RHerder
    from stellar_core_tpu.ledger.manager import LedgerManager as RLM
    from stellar_core_tpu.overlay import OverlayManager as ROverlay
    from stellar_core_tpu.overlay.peer import LoopbackPeer as RLoopback
    from stellar_core_tpu.simulation.simulation import qset_of as r_qset_of
    from stellar_core_tpu.util.clock import ClockMode as RMode
    from stellar_core_tpu.util.clock import VirtualClock as RClock
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.overlay import OverlayManager
    from stellar_core_tpu_torch.overlay.peer import LoopbackPeer
    from stellar_core_tpu_torch.simulation.simulation import qset_of
    from stellar_core_tpu_torch.testutils import network_id
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    nid = network_id("torch cross-package net")
    ids = [bytes([0x1a]) * 32, bytes([0x1b]) * 32]
    ska, skb = SecretKey(ids[0]), RSecret(ids[1])
    pks = [ska.public_key.ed25519, skb.public_key.ed25519]
    pclock, rclock = (VirtualClock(ClockMode.VIRTUAL_TIME),
                      RClock(RMode.VIRTUAL_TIME))
    lma = LedgerManager(nid)
    lma.start_new_ledger()
    ha = Herder(pclock, lma, ska, qset_of(pks, 2))
    oa = OverlayManager(pclock, ha, nid, ska, auth_seed=b"a" * 32)
    lmb = RLM(nid)
    lmb.start_new_ledger()
    hb = RHerder(rclock, lmb, skb, r_qset_of(pks, 2))
    ob = ROverlay(rclock, hb, nid, skb, auth_seed=b"b" * 32)
    pa = LoopbackPeer(oa, we_called_remote=True)
    pb = RLoopback(ob, we_called_remote=False)
    pa.partner, pb.partner = pb, pa
    oa._register_peer(pa)
    ob._register_peer(pb)
    pb.connect_handler()
    pa.connect_handler()

    def crank(n):
        for _ in range(n):
            pclock.crank()
            rclock.crank()

    crank(50)
    assert pa.is_authenticated() and pb.is_authenticated()
    assert pa.peer_id == pks[1] and pb.peer_id == pks[0]
    assert oa.num_authenticated() == ob.num_authenticated() == 1


def _syncing_node(tmp_path, pkg: str):
    """A node of `pkg` (either package) that starts out of sync at genesis
    beside an archive published to ledger 63 by the same package: the
    tip ledger and hash, and the node's Application on a virtual clock."""
    import importlib
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    nid = mod("testutils").network_id("sync gap net")
    src = mod("ledger.manager").LedgerManager(nid)
    src.start_new_ledger()
    arch = str(tmp_path / f"{pkg}-arch")
    hist = mod("history.manager").HistoryManager(
        src, "sync gap net", [mod("history.archive").FileHistoryArchive(arch)])
    gen = mod("simulation.loadgen").LoadGenerator(src, hist, seed=31)
    gen.create_accounts(8, per_ledger=8)
    gen.payment_ledgers(20, txs_per_ledger=2)
    gen.run_to_checkpoint_boundary()
    cfg = mod("main.config").Config.from_dict({
        "NETWORK_PASSPHRASE": "sync gap net", "PEER_PORT": 0,
        "ACCEL": "none", "HISTORY": {"main": {"get": arch}}})
    clock_mod = mod("util.clock")
    clock = clock_mod.VirtualClock(clock_mod.ClockMode.VIRTUAL_TIME)
    app = mod("main.application").Application(cfg, clock=clock,
                                              listen=False)
    app.start()
    return (src.last_closed_ledger_seq, src.lcl_hash), app, clock


def test_a_node_that_starts_past_the_slot_memory_reaches_the_archive(
        tmp_path):
    """A node that starts syncing (a restart) and then sees externalized
    values past the peers' slot memory catches up from the archive: the
    herder's sync-gap hook reaches the Application's archive catchup.
    The reference leaves the hook unset, and its node stays where it
    started."""
    (tip, tip_hash), app, clock = _syncing_node(tmp_path,
                                                "stellar_core_tpu_torch")
    try:
        assert app.herder.state == "syncing"
        assert app.lm.last_closed_ledger_seq == 1 and tip == 63
        app.herder._buffered[tip + 3] = object()   # the network, far ahead
        app.herder._drain_buffered()
        assert app._catchup_work is not None
        assert clock.crank_until(
            lambda: app.lm.last_closed_ledger_seq >= tip, timeout=600)
        assert app.lm.lcl_hash == tip_hash
    finally:
        app.stop()
    _, ref_app, _ = _syncing_node(tmp_path, "stellar_core_tpu")
    try:
        ref_app.herder._buffered[tip + 3] = object()
        ref_app.herder._drain_buffered()
        assert ref_app._catchup_work is None
        assert ref_app.lm.last_closed_ledger_seq == 1
    finally:
        ref_app.stop()


def test_runs_signal_handler_only_ends_the_crank_loop(tmp_path,
                                                      monkeypatch):
    """SIGTERM to `run` (on the main thread) ends the crank loop; the
    node is stopped after run() returns, not inside the handler, which
    would tear the node down in the middle of whatever the main thread
    was doing."""
    import threading
    from stellar_core_tpu_torch.main import application, commandline
    events = []
    real_stop, real_run = application.Application.stop, \
        application.Application.run

    def stop(self):
        events.append(("stop", self._stopped))
        real_stop(self)

    def run(self):
        real_run(self)
        events.append(("run returned", self._stopped))

    monkeypatch.setattr(application.Application, "stop", stop)
    monkeypatch.setattr(application.Application, "run", run)
    conf = tmp_path / "n.cfg"
    conf.write_text('RUN_STANDALONE = true\nPEER_PORT = 0\nACCEL = "none"\n'
                    f"HTTP_PORT = {_free_port()}\n")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                  signal.SIGTERM)}
    timer = threading.Timer(1.5, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        assert commandline.main(["run", "--conf", str(conf)]) == 0
    finally:
        timer.cancel()
        for s, h in handlers.items():
            signal.signal(s, h)
    assert events == [("run returned", True), ("stop", True)]


@pytest.mark.parametrize("pkg, ok", [("stellar_core_tpu_torch", True),
                                     ("stellar_core_tpu", False)],
                         ids=["port", "reference"])
def test_self_check_reads_an_unpersisted_merge_by_its_inputs(tmp_path,
                                                             pkg, ok):
    """A merge that finished in memory after the last close (a reloaded
    node re-runs the merges its stored state left pending) has no file
    yet; its inputs do, and they are what restart needs.  The port's
    self-check holds them; the reference's reports the output missing."""
    import importlib
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    lm = mod("ledger.manager").LedgerManager(
        mod("testutils").network_id("self check net"))
    lm.start_new_ledger()
    gen = mod("simulation.loadgen").LoadGenerator(lm, seed=5)
    gen.create_accounts(8, per_ledger=4)
    gen.payment_ledgers(4, txs_per_ledger=2)
    bdir = mod("bucket.manager").BucketDir(str(tmp_path / "buckets"))
    level = next(lvl for lvl in lm.bucket_list.levels
                 if not lvl.curr.is_empty() and not lvl.snap.is_empty())
    for lvl in lm.bucket_list.levels:
        bdir.save(lvl.curr)
        bdir.save(lvl.snap)
        if lvl.next is not None:
            bdir.save(lvl.next.resolve())
    # finished in memory, never saved: the output of merging the level
    level.next = mod("bucket.future").FutureBucket(
        level.curr, level.snap, True, lm.lcl_header.ledgerVersion)
    assert level.next.done
    report = mod("main.selfcheck").self_check(lm, bucket_dir=bdir)
    got = {c["name"]: c["ok"] for c in report["checks"]}
    assert got == {"lcl-header-hash": True, "bucket-list-hash": True,
                   "bucket-files": ok}
