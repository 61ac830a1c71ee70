"""The port's catchup seam against the reference's, on the CPU.

One archive, published by the reference (its LoadGenerator and
HistoryManager: 16 accounts, four of them given an extra ed25519 signer
that co-signs their payments, then payment ledgers to the checkpoint at
191; every tenth co-signed payment's extra signature corrupted), is
replayed by both packages' CatchupManager:

* accel off, with the native apply engine on (where the port's engine
  runs: capply built and libsodium loading) and off: the same hash;
* accel on, the port on the plain versions (``accel_device="cpu"``), the
  reference on its jitted programs on jax's CPU, for hot_threshold
  1 << 62 (K-G's path) and 4 (K-B + K-T's), with the race profile pinned
  in both packages: the same hash, offload_hit_rate() and pipeline
  counters;
* catchup_minimal, catchup_recent and catchup_range: the same states.

Then the port's own surface: the configuration's ACCEL values, the
command line (``python -m stellar_core_tpu_torch catchup``, single stream
and ``--parallel 3``, and ``catchup-range``) with ``--accel cpu``, and
its refusal of ``--accel cuda`` without a card; the port's mesh env for
range workers; and the repair that lets the pipeline's worker threads
share a verifier (its lock: two threads through one verifier with key
tables evicted under them give the reference's verdicts).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu import xdr as RX
from stellar_core_tpu.catchup import catchup as ref_catchup
from stellar_core_tpu.crypto import keys as ref_keys
from stellar_core_tpu.crypto import sodium as ref_sodium
from stellar_core_tpu.crypto.keys import SecretKey as RefSecretKey
from stellar_core_tpu.history.archive import FileHistoryArchive as RefArchive
from stellar_core_tpu.history.manager import HistoryManager as RefHistory
from stellar_core_tpu.ledger.manager import LedgerManager as RefLedger
from stellar_core_tpu.simulation.loadgen import LoadGenerator as RefLoadGen
from stellar_core_tpu.testutils import build_tx as ref_build_tx
from stellar_core_tpu.testutils import native_payment_op as ref_payment
from stellar_core_tpu.testutils import network_id

from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.accel import mesh
from stellar_core_tpu_torch.catchup import catchup as port_catchup
from stellar_core_tpu_torch.catchup.parallel import (ParallelCatchup,
                                                     plan_parallel_ranges)
from stellar_core_tpu_torch.crypto import keys as port_keys
from stellar_core_tpu_torch.history.archive import \
    FileHistoryArchive as PortArchive
from stellar_core_tpu_torch.ledger.native_apply import \
    native_apply_available
from stellar_core_tpu_torch.main.config import Config
from stellar_core_tpu_torch.util.metrics import reset_registry

ROOT = Path(__file__).resolve().parent.parent
PASSPHRASE = "torch catchup differential net"
NID = network_id(PASSPHRASE)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """The plain versions are many small operations: one torch thread, here
    and in any worker this test spawns."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """(archive dir, the source chain's tip ledger and hash)."""
    path = tmp_path_factory.mktemp("ref-archive")
    mgr = RefLedger(NID)
    mgr.start_new_ledger()
    history = RefHistory(mgr, PASSPHRASE, [RefArchive(str(path))])
    gen = RefLoadGen(mgr, history, seed=9)
    gen.create_accounts(16, per_ledger=8)
    extras = {}
    for i, acct in enumerate(gen.accounts[:4]):
        extras[i] = RefSecretKey(bytes([0x90 + i]) * 32)
        gen._close([acct.tx([RX.Operation(
            body=RX.OperationBody.setOptionsOp(RX.SetOptionsOp(
                signer=RX.Signer(key=RX.SignerKey.ed25519(
                    extras[i].public_key.ed25519), weight=1))))])])
    n = 0
    for r in range(40):
        frames = []
        for i, extra in extras.items():
            acct = gen.accounts[i]
            f = ref_build_tx(NID, acct.secret, acct.next_seq(),
                             [ref_payment(gen.root.account_id, 100 + r)],
                             extra_signers=[extra])
            if n % 10 == 9:
                d = f.envelope.value.signatures[1]
                d.signature = bytes([d.signature[0] ^ 1]) + d.signature[1:]
            n += 1
            frames.append(f)
        gen._close(frames)
        gen.payment_ledgers(1, txs_per_ledger=2)
    gen.payment_ledgers(60, txs_per_ledger=2)
    gen.run_to_checkpoint_boundary()
    assert history.published_checkpoints == [63, 127, 191]
    return str(path), mgr.last_closed_ledger_seq, mgr.lcl_hash


@pytest.fixture
def race_in_both(monkeypatch):
    """The race profile with a budget no group misses, pinned in both
    packages (the reference's no_race fixture, test_history_catchup.py):
    each collect waits for its group, so the counters are exact.  An
    infinite cost a signature makes every collect's budget the pipeline's
    COLLECT_TIMEOUT_S, at which a miss is not counted as a race: a finite
    one (10 s a signature gave a group of one or two pairs 12.5-25 s) is
    missed on a loaded machine by a group whose job builds its key tables
    or compiles, on one side only.  That timeout, 180 s, is itself within
    reach: the reference's first K-B+K-T group with the native engine
    (its table programs compiling on jax's CPU) takes about 130 s on an
    idle eight-core machine and 180-190 s beside a six-worker test run,
    where its first collect then times out and its hit rate is 0; so it
    is raised here for both packages, and a collect still waits for its
    group rather than for a clock."""
    for mod in (ref_catchup, port_catchup):
        pipe = mod.PreverifyPipeline
        monkeypatch.setattr(pipe, "DEFAULT_PROFILE", pipe.PROFILE_RACE)
        monkeypatch.setattr(pipe, "RACE_CPU_S_PER_SIG", float("inf"))
        monkeypatch.setattr(pipe, "COLLECT_TIMEOUT_S", 1800.0)


def catchup(root, archive_dir, how="complete", **kw):
    """(manager, CatchupManager) of one catchup by `root`'s package, the
    verify cache cleared first."""
    mod, keys, Archive = ((ref_catchup, ref_keys, RefArchive) if root == "ref"
                          else (port_catchup, port_keys, PortArchive))
    keys.clear_verify_cache()
    args = {k: kw.pop(k) for k in ("count", "checkpoint", "seed_checkpoint",
                                   "to_ledger") if k in kw}
    cm = mod.CatchupManager(NID, PASSPHRASE, **kw)
    archive = Archive(archive_dir)
    if how == "complete":
        mgr = cm.catchup_complete(archive, **args)
    elif how == "minimal":
        mgr = cm.catchup_minimal(archive, **args)
    elif how == "recent":
        mgr = cm.catchup_recent(archive, **args)
    else:
        mgr, seed_hash = cm.catchup_range(archive, args["seed_checkpoint"],
                                          args["to_ledger"])
        cm.seed_hash = seed_hash
    return mgr, cm


def state_of(mgr) -> tuple:
    return (mgr.last_closed_ledger_seq, mgr.lcl_hash,
            mgr.bucket_list.hash(), mgr.root.entry_count())


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_catchup_complete_equals_reference(published, native):
    archive_dir, tip, tip_hash = published
    port, pcm = catchup("port", archive_dir, native=native)
    ref, rcm = catchup("ref", archive_dir, native=native)
    assert state_of(port) == state_of(ref)
    assert (port.last_closed_ledger_seq, port.lcl_hash) == (tip, tip_hash)
    # native runs where the engine does: capply built and libsodium loading
    assert pcm.native == (native and native_apply_available())
    assert pcm.native == rcm.native or not native_apply_available()


@pytest.mark.parametrize("native", [None, False], ids=["auto", "python"])
@pytest.mark.parametrize("hot", [1 << 62, 4], ids=["K-G", "K-B+K-T"])
def test_accel_catchup_equals_reference(published, race_in_both, hot,
                                        native):
    """The port on the plain versions, the reference on jax's CPU: the same
    replay, hit rate and counters (every pairable signature shipped, the
    corrupted ones among them, rejected)."""
    archive_dir, tip, tip_hash = published
    reset_registry()
    port, pcm = catchup("port", archive_dir, accel=True, accel_device="cpu",
                        accel_chunk=256, accel_hot_threshold=hot,
                        native=native)
    ref, rcm = catchup("ref", archive_dir, accel=True, accel_chunk=256,
                       accel_hot_threshold=hot, native=native)
    assert state_of(port) == state_of(ref)
    assert port.lcl_hash == tip_hash
    assert pcm.offload_hit_rate() == rcm.offload_hit_rate() == 1.0
    counts = lambda stats: {k: v for k, v in stats.items()
                            if not isinstance(v, float)}
    assert counts(pcm.stats) == counts(rcm.stats)
    assert pcm.stats["sigs_total"] > 200
    verifier = TE._verifier_for(256, 256, hot, "cpu")
    if hot == 4:
        assert verifier.stats["tables_built"] >= 1
    else:
        assert verifier.stats["table_sigs"] == 0


def test_catchup_minimal_recent_and_range_equal_reference(published):
    archive_dir, tip, tip_hash = published
    for how, kw in (("minimal", {}), ("minimal", {"checkpoint": 127}),
                    ("recent", {"count": 20}),
                    ("range", {"seed_checkpoint": 63, "to_ledger": 191}),
                    ("range", {"seed_checkpoint": None, "to_ledger": 127})):
        port, pcm = catchup("port", archive_dir, how, **dict(kw))
        ref, rcm = catchup("ref", archive_dir, how, **dict(kw))
        assert state_of(port) == state_of(ref), (how, kw)
        if how == "range":
            assert pcm.seed_hash == rcm.seed_hash, kw
    assert catchup("port", archive_dir, "recent", count=20)[0].lcl_hash \
        == tip_hash


def test_pipeline_threads_its_device_to_the_verifier(published,
                                                      race_in_both,
                                                      monkeypatch):
    """accel_device / accel_devices reach verify_batch_async as the
    devices the pipeline resolved, and each device job runs under the
    dispatching thread's streams (none on the CPU)."""
    calls = []
    real = TE.verify_batch_async

    def spy(*args, **kw):
        calls.append((threading.current_thread().name, kw.get("devices")))
        return real(*args, **kw)

    monkeypatch.setattr(TE, "verify_batch_async", spy)
    archive_dir, tip, tip_hash = published
    mgr, cm = catchup("port", archive_dir, accel=True,
                      accel_devices=["cpu", "cpu"], accel_chunk=256,
                      to_ledger=127)
    assert mgr.last_closed_ledger_seq == 127
    assert cm.offload_hit_rate() == 1.0
    assert calls and all(c == ("preverify-device", (CPU, CPU))
                         for c in calls), calls
    from stellar_core_tpu_torch import device
    assert device.current_streams((CPU, CPU)) == {}
    with device.using((CPU,), {}):
        pass


def _failing_device(monkeypatch):
    """Every device job raises, as a kernel that does not build would."""
    def gate(i):
        raise RuntimeError(f"K-G launch failed (group {i})")
    monkeypatch.setattr(port_catchup.PreverifyPipeline, "DEVICE_GATE",
                        staticmethod(gate))


def _one_group(profile, on_card):
    """A pipeline on the plain versions with one dispatched group of
    checkpoint 63, its job ended; `on_card` gives it the card's rule."""
    pipe = port_catchup.PreverifyPipeline(NID, 256, profile=profile,
                                          device="cpu")
    assert pipe.raise_device_errors is False
    pipe.raise_device_errors = on_card
    pipe._enqueue_group([63], [bytes(32)], [bytes(64)], [bytes(32)], 0.0,
                        {63: 1})
    assert pipe._groups[63]["job"][1].wait(60)
    return pipe


@pytest.mark.parametrize("profile", ["poll", "race"])
def test_a_failed_device_job_fails_on_the_card_and_falls_back_on_the_cpu(
        profile, monkeypatch):
    """On the card a device job that raised is a fault: collect raises
    CatchupError, and so does close for a group no collect saw.  On the
    plain versions the group falls back to CPU verification (the
    reference's semantics)."""
    _failing_device(monkeypatch)
    pipe = _one_group(profile, on_card=True)
    with pytest.raises(port_catchup.CatchupError,
                       match=r"\[63\] failed on cpu: RuntimeError"):
        pipe.collect(63)
    pipe.close()
    pipe = _one_group(profile, on_card=True)
    with pytest.raises(port_catchup.CatchupError, match="K-G launch failed"):
        pipe.close()
    pipe = _one_group(profile, on_card=False)
    pipe.collect(63)
    pipe.close()
    assert pipe.stats["collect_fallbacks"] == 1
    assert pipe.stats.get("sigs_shipped", 0) == 0


def test_catchup_fails_when_a_device_job_fails_on_the_card(published,
                                                           monkeypatch):
    """The whole replay: with the card's rule, a failing device job ends
    the catchup with CatchupError instead of verifying on the CPU."""
    _failing_device(monkeypatch)
    init = port_catchup.PreverifyPipeline.__init__

    def on_card(self, *args, **kw):
        init(self, *args, **kw)
        self.raise_device_errors = True

    monkeypatch.setattr(port_catchup.PreverifyPipeline, "__init__", on_card)
    archive_dir, tip, tip_hash = published
    with pytest.raises(port_catchup.CatchupError, match="failed on cpu"):
        catchup("port", archive_dir, accel=True, accel_device="cpu",
                accel_chunk=256, to_ledger=127)


def test_config_accel_values():
    assert Config.from_dict({"ACCEL": "cuda"}).accel() == (True, None)
    assert Config.from_dict({"ACCEL": "cpu"}).accel() == (True, "cpu")
    assert Config.from_dict({"ACCEL": "none"}).accel() == (False, None)
    # the port's default is the card (the reference's is "none")
    assert Config.from_dict({}).accel() == (True, None)
    with pytest.raises(ValueError, match="use \"cuda\""):
        Config.from_dict({"ACCEL": "tpu"})
    cfg = Config()
    cfg.ACCEL = "tpu"
    with pytest.raises(ValueError, match="not one of none, cuda, cpu"):
        cfg.accel()


def _cli(*args, conf_text=None, tmp_path=None, timeout=600):
    conf = tmp_path / "node.cfg"
    conf.write_text(conf_text or f'NETWORK_PASSPHRASE = "{PASSPHRASE}"\n')
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch", *args,
         *(("--conf", str(conf)) if args[0] == "catchup" else ())],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cli_catchup_single_and_parallel_equal_reference(published,
                                                          tmp_path):
    archive_dir, tip, tip_hash = published
    want = f"caught up to ledger {tip} hash {tip_hash.hex()}"
    single = _cli("catchup", "--archive", archive_dir, "--accel", "cpu",
                  tmp_path=tmp_path)
    assert single.returncode == 0, single.stderr[-3000:]
    assert want in single.stdout
    par = _cli("catchup", "--archive", archive_dir, "--accel", "cpu",
               "--parallel", "3", "--report", str(tmp_path / "par.json"),
               tmp_path=tmp_path)
    assert par.returncode == 0, par.stderr[-3000:]
    assert want in par.stdout and "3 ranges, 2 stitches verified" \
        in par.stdout
    ranges = json.loads((tmp_path / "par.json").read_text())["ranges"]
    assert [r["seed_checkpoint"] for r in ranges] == [None, 63, 127]
    assert all(0.0 <= r["sig_offload_hit_rate"] <= 1.0 for r in ranges)
    # the plain versions launch no kernel
    assert all(r["launches"] == {"K-G": 0, "K-B": 0, "K-T": 0}
               for r in ranges)


def test_cli_catchup_range_equals_reference(published, tmp_path):
    archive_dir, tip, tip_hash = published
    ref, rcm = catchup("ref", archive_dir, "range", seed_checkpoint=63,
                       to_ledger=127)
    out = _cli("catchup-range", "--archive", archive_dir, "--passphrase",
               PASSPHRASE, "--to", "127", "--seed-checkpoint", "63",
               "--workdir", str(tmp_path / "w"),
               "--result", str(tmp_path / "r.json"), "--accel", "cpu",
               tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "r.json").read_text())
    assert rec["final_hash"] == ref.lcl_hash.hex()
    assert rec["seed_header_hash"] == rcm.seed_hash.hex()


def test_cli_refuses_cuda_without_a_card_and_tpu(published, tmp_path,
                                                  monkeypatch):
    """--accel cuda (or a config's default ACCEL) where there is no card,
    and a config's ACCEL = "tpu", fail loudly: a non-zero exit, no replay;
    --report outside --parallel is refused."""
    # the refusal is of a machine without a card: hide any
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    archive_dir, tip, tip_hash = published
    for args, conf, msg in (
            (("--accel", "cuda"), None, "no CUDA device"),
            (("--accel", "cuda", "--parallel", "3"), None, "no CUDA device"),
            # the config's default ACCEL is the card
            ((), None, "no CUDA device"),
            (("--accel", "cpu", "--report", str(tmp_path / "x.json")), None,
             "--report applies to --parallel catchup only"),
            ((), f'NETWORK_PASSPHRASE = "{PASSPHRASE}"\nACCEL = "tpu"\n',
             "ACCEL = 'tpu' is not one of")):
        out = _cli("catchup", "--archive", archive_dir, *args,
                   conf_text=conf, tmp_path=tmp_path)
        assert out.returncode == 1, (args, out.stdout, out.stderr[-2000:])
        assert msg in out.stderr and "caught up" not in out.stdout
    worker = _cli("catchup-range", "--archive", archive_dir, "--passphrase",
                  PASSPHRASE, "--to", "127", "--workdir", str(tmp_path / "w"),
                  "--result", str(tmp_path / "r.json"), "--accel", "cuda",
                  tmp_path=tmp_path)
    assert worker.returncode == 1
    assert "no CUDA device" in json.loads(
        (tmp_path / "r.json").read_text())["error"]


def test_mesh_env_pins_one_card_a_worker(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # one card: every worker gets it
    for i in range(3):
        env = mesh.worker_device_env(i, 3, "cuda")
        assert env == {mesh.ENV_DEVICE_INDEX: str(i),
                       mesh.ENV_DEVICE_COUNT: "3",
                       "CUDA_VISIBLE_DEVICES": "0"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [mesh.worker_device_env(i, 4, "gpu")["CUDA_VISIBLE_DEVICES"]
            for i in range(4)] == ["0", "1", "2", "3"]
    # a parent pinned to a subset hands out its own cards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert [mesh.worker_device_env(i, 2, "cuda")["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["2", "3", "2"]
    cpu = mesh.worker_device_env(1, 4, "cpu")
    assert cpu["CUDA_VISIBLE_DEVICES"] == "" and not any(
        k.startswith(("TPU_", "XLA_", "JAX_")) for k in cpu)
    with pytest.raises(ValueError, match="unknown mesh platform"):
        mesh.worker_device_env(0, 1, "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.resolve_platform("auto") == "cpu"


def test_worker_cmdline_runs_the_port_and_threads_the_mesh(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(port_catchup.PreverifyPipeline, "DEFAULT_DEVICE",
                        None)
    pc = ParallelCatchup(str(tmp_path / "a"), PASSPHRASE, workers=2,
                         workdir=str(tmp_path / "w"), accel=True,
                         mesh_devices=2, mesh_platform="cuda")
    pc._specs = plan_parallel_ranges(255, 2)
    pc._target = 255
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cmd = pc._worker_cmdline(pc._specs[1])
    assert "-m stellar_core_tpu_torch catchup-range" in cmd
    assert "--accel cuda" in cmd
    assert f"{mesh.ENV_DEVICE_INDEX}=1" in cmd
    assert "CUDA_VISIBLE_DEVICES=0" in cmd
    # a pinned pipeline pins the workers: the plain versions
    monkeypatch.setattr(port_catchup.PreverifyPipeline, "DEFAULT_DEVICE",
                        "cpu")
    pc2 = ParallelCatchup(str(tmp_path / "a"), PASSPHRASE, workers=2,
                          workdir=str(tmp_path / "w2"), accel=True)
    pc2._specs = plan_parallel_ranges(255, 2)
    assert "--accel cpu" in pc2._worker_cmdline(pc2._specs[0])
    with pytest.raises(ValueError, match="accel_device"):
        ParallelCatchup(str(tmp_path / "a"), PASSPHRASE, accel=True,
                        accel_device="tpu")


def test_two_threads_share_a_verifier_with_evictions():
    """The repair: a verifier used from two threads at once (two worker
    generations) never interleaves key-table installs with table
    verifies.  Four slots, six keys hot from the first use: every call
    evicts tables the other thread's call may be reading.  Every verdict
    is libsodium's, through the reference's crypto."""
    sks = [ref_sodium.sign_seed_keypair(bytes([i + 1]) * 32)
           for i in range(6)]
    rng = np.random.default_rng(5)
    batches = []
    for b in range(8):
        pks, sigs, msgs = [], [], []
        for j in range(12):
            pk, sk = sks[rng.integers(6)]
            msg = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
            sig = ref_sodium.sign_detached(msg, sk)
            if j % 5 == 4:
                sig = sig[:10] + bytes([sig[10] ^ 4]) + sig[11:]
            pks.append(pk), sigs.append(sig), msgs.append(msg)
        want = [ref_sodium.verify_detached(s, m, p)
                for p, s, m in zip(pks, sigs, msgs)]
        batches.append((pks, sigs, msgs, want))
    verifier = TE.Ed25519BatchVerifier(chunk_size=5, table_slots=4,
                                       hot_threshold=1, device="cpu")
    got, errors = {}, []
    start = threading.Barrier(2)

    def worker(k):
        try:
            start.wait()
            for b in range(k, len(batches), 2):
                pks, sigs, msgs, _ = batches[b]
                got[b] = verifier.verify_async(pks, sigs, msgs)().tolist()
        except BaseException as e:      # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    assert got == {b: batch[3] for b, batch in enumerate(batches)}
    stats = verifier.stats
    assert stats["tables_built"] > 4      # slots were reused
    # a batch's keys beyond the four slots stay on the generic path
    assert stats["table_sigs"] + stats["generic_sigs"] == 8 * 12
    assert stats["table_sigs"] > stats["generic_sigs"] > 0


def _parked_group(pipe, release, cps):
    """A dispatched group of two pairs over checkpoints `cps` whose device
    job finishes when `release` is set."""
    def job():
        release.wait(30.0)
        return np.ones(2, dtype=bool), 0.01

    group = {"job": pipe._submit(job),
             "pks": [bytes([0xA1 + i]) * 32 for i in range(2)],
             "sigs": [bytes([0xB1 + i]) * 64 for i in range(2)],
             "msgs": [b"last-group %d" % i for i in range(2)],
             "checkpoints": list(cps),
             "pairs_by_cp": {cp: 2 for cp in cps}, "collected_cps": set()}
    for cp in cps:
        pipe._groups[cp] = group
    pipe._live_groups.append(group)
    return group


def test_poll_waits_for_the_group_of_the_last_checkpoint():
    """Under poll a collect does not wait for its group, save the collect
    of the replay's last checkpoint: no later collect could take that
    group's verdicts.  Until the device has answered once (a cold start)
    that wait may take the wedge timeout; after, the group's CPU cost (at
    least 0.25 s).  The reference's poll collect has no such case."""
    import time
    pipe = port_catchup.PreverifyPipeline(NID, 256, device="cpu")
    assert pipe.profile == pipe.PROFILE_POLL
    try:
        cold = threading.Event()
        _parked_group(pipe, cold, (63,))
        threading.Timer(0.5, cold.set).start()
        t0 = time.perf_counter()
        pipe.collect(63, last=True)            # cold: waits past 0.25 s
        assert time.perf_counter() - t0 >= 0.45
        assert pipe.stats["sigs_shipped"] == 2
        assert not pipe.stats.get("sigs_race_lost")
        parked = threading.Event()
        _parked_group(pipe, parked, (127,))
        t0 = time.perf_counter()
        pipe.collect(127)                      # not the last: no wait
        assert time.perf_counter() - t0 < 0.2
        assert pipe.stats["sigs_race_lost"] == 2
        parked.set()
        warm = threading.Event()
        _parked_group(pipe, warm, (191,))
        threading.Timer(0.1, warm.set).start()
        # warm: the wait is the group's CPU cost, here made long enough
        # that a loaded machine's late timer still falls inside it
        pipe.RACE_CPU_S_PER_SIG = 10.0
        pipe.collect(191, last=True)
        assert pipe.stats["sigs_race_lost"] == 2
        assert pipe.stats["sigs_shipped"] == 6
        assert pipe.stats["sigs_late_seeded"] == 2   # 127's, ripened late
        assert pipe.stats["collect_wait_s"] >= 0.55
    finally:
        pipe.close()
        port_keys.clear_verify_cache()
    assert "last" not in ref_catchup.PreverifyPipeline.collect.__code__ \
        .co_varnames


def test_a_one_checkpoint_replay_takes_its_verdicts_from_the_device(
        published):
    """A catchup to the first checkpoint has one group and one collect:
    under poll its verdicts come from the device (here the plain
    versions), not the CPU, and the hash is the reference's."""
    path, _, _ = published
    mgr, cm = catchup("port", path, to_ledger=63, accel=True,
                      accel_device="cpu", accel_chunk=256)
    want, _ = catchup("ref", path, to_ledger=63)
    assert state_of(mgr) == state_of(want)
    assert cm.accel_profile in (None, "poll")
    assert cm.offload_hit_rate() > 0.5, cm.stats


@pytest.mark.parametrize("owns_its_clock", [True, False],
                         ids=["catchup-manager", "node-crank-loop"])
def test_only_a_replay_on_its_own_clock_waits_at_its_last_collect(
        published, monkeypatch, owns_its_clock):
    """CatchupManager's replay (a catchup command, a range worker) marks
    its last collect, which may then wait for the card.  A CatchupWork
    built as a running node's archive catchup builds it
    (Application.maybe_start_archive_catchup) shares the node's crank
    loop and never marks one, as the reference never waits."""
    from stellar_core_tpu_torch.historywork.works import CatchupWork
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock
    path, _, _ = published
    seen = []
    real = port_catchup.PreverifyPipeline.collect

    def collect(self, checkpoint, last=False):
        seen.append((checkpoint, last))
        return real(self, checkpoint, last)

    monkeypatch.setattr(port_catchup.PreverifyPipeline, "collect", collect)
    if owns_its_clock:
        mgr, _ = catchup("port", path, to_ledger=127, accel=True,
                         accel_device="cpu", accel_chunk=256)
    else:
        port_keys.clear_verify_cache()
        mgr = LedgerManager(NID)
        mgr.start_new_ledger()
        clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        work = CatchupWork(clock, mgr, PortArchive(path), 127, NID,
                           accel=True, accel_device="cpu", accel_chunk=256,
                           stats={})
        work.start()
        assert clock.crank_until(lambda: work.done, timeout=600)
        assert work.succeeded
    want, _ = catchup("ref", path, to_ledger=127)
    assert state_of(mgr) == state_of(want)
    assert sorted(seen) == [(63, False), (127, owns_its_clock)]
