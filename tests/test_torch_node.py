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
