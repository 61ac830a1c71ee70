"""A standalone validator taking /tx traffic: `python -m
stellar_core_tpu_torch run` (main/commandline.main on the main thread, as
the CLI runs it) on the configuration's TOML, with its HTTP /tx as the
only way in.

Set-up, on a helper thread while the node serves: wait for /info, raise
the tx-set limit over /upgrades so that the accounts' creations fit one
ledger, create the accounts with the node's own transactions (the root
funds funders, each funder creates its share), set the limit to the
configuration's, then sign every transaction of the window from the
seed.  The window: the
mix's clients (lib/txclient.py, a process of their own) post open loop;
every transaction due in the window is then waited for until it is
applied or the wait ends.  The node is stopped by SIGTERM.

What is compared: each /tx reply's status (a valid transaction PENDING,
one with a corrupted signature never applied), that each accepted valid
transaction is applied, and each closed ledger's hash against the frozen
reference's close of the same transaction set and close time."""

from __future__ import annotations

import gc
import json
import math
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from ..lib import harness, ledgers as L
from ..lib import trace as tr

WORK = harness.ROOT / "build" / "portbench" / "work"
# the statuses the node's /tx answers with
_STATUSES = ("PENDING", "ERROR", "DUPLICATE", "TRY_AGAIN_LATER", "BANNED",
             "FILTERED")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, path: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def p95(values: list) -> float:
    """The 95th percentile by nearest rank."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Cell:
    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device=None, workdir=None):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.name = cell["workload"]["name"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device   # None: the card; "cpu": plain versions
        self.workdir = str(workdir or WORK / self.name)
        self.nid = L.network_id(self.cfg["passphrase"])
        self.closes, self.app, self.error = [], None, None
        self.verdicts, self.sent = {}, {}
        self._client = None

    def setup(self) -> None:
        from stellar_core_tpu_torch.crypto import keys
        keys.clear_verify_cache()   # as a new node process has it
        shutil.rmtree(self.workdir, ignore_errors=True)
        os.makedirs(self.workdir)
        self.port = _free_port()
        node = dict(self.cfg["node"], HTTP_PORT=self.port,
                    ACCEL="cuda" if self.device is None else self.device)
        state = self.workdir
        lines = [f'NETWORK_PASSPHRASE = "{self.cfg["passphrase"]}"',
                 f'NODE_SEED = "{self._node_seed()}"',
                 f'DATABASE = "{state}/node.db"',
                 f'BUCKET_DIR_PATH = "{state}/buckets"']
        for k, v in node.items():
            lines.append(f"{k} = " + (json.dumps(v) if isinstance(v, str)
                                       else str(v).lower()
                                       if isinstance(v, bool) else str(v)))
        lines += ["", "[HISTORY.local]", f'get = "{state}/archive"',
                  f'put = "{state}/archive"']
        self.conf = os.path.join(state, "node.toml")
        with open(self.conf, "w") as f:
            f.write("\n".join(lines) + "\n")

    def _node_seed(self) -> str:
        from ..refcore.crypto import strkey
        return strkey.encode_seed(L.key_seeds("node", 0, 1)[0])

    # -- the node, on this (main) thread --------------------------------
    def run(self) -> dict:
        from stellar_core_tpu_torch.main import application, commandline
        base, cell = application.Application, self

        class Recorded(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                hook = self.herder.ledger_closed_hook

                def closed(arts):
                    hook(arts)
                    cell._closed(arts)

                self.herder.ledger_closed_hook = closed
                cell.app = self

        handlers = {s: signal.getsignal(s)
                    for s in (signal.SIGINT, signal.SIGTERM)}
        self.out = {}
        # the profiler starts here, on the main thread; the helper marks
        # the window inside it
        self.trace = tr.DeviceTrace() if self.trace else None
        if self.trace is not None:
            self.trace.start()
        helper = threading.Thread(target=self._drive, name="portbench-drive",
                                  daemon=True)
        application.Application = Recorded
        try:
            helper.start()
            rc = commandline.main(["run", "--conf", self.conf])
        finally:
            application.Application = base
            for s, h in handlers.items():
                signal.signal(s, h)
            self._stop_client()
            helper.join(120.0)
        if self.error is None and rc != 0:
            self.error = f"the node exited {rc}"
        if self.error is not None:
            print(f"portbench: {self.error}", file=sys.stderr)
        trace = self.trace
        if trace is not None:
            trace.stop()
            self.out["trace"] = trace
            self.out["breakdown"] = {
                "device_ops": tr.op_seconds(trace.ops),
                "idle_gaps": tr.idle_gaps(
                    trace.ops, trace.t0_ns, trace.t1_ns, self._close_spans(),
                    "host: /tx intake and admission between closes")}
        return self.out

    def _closed(self, arts) -> None:
        """The node's ledger-closed hook (crank loop): record the close and
        tell the clients."""
        at = time.monotonic()
        self.closes.append((at, arts))
        c = self._client
        if c is not None and c.stdin is not None:
            try:
                c.stdin.write(
                    f"{arts.header_entry.header.ledgerSeq} {at}\n".encode())
                c.stdin.flush()
            except (OSError, ValueError):   # the clients have finished
                pass

    def _stop_client(self) -> None:
        c, self._client = self._client, None
        if c is not None and c.poll() is None:
            c.kill()
            c.wait(30)

    # -- set-up and window, on the helper thread ------------------------
    def _drive(self) -> None:
        up = False
        try:
            self._wait("/info", lambda: self.app is not None
                       and self._answers(), 120.0, every=0.05)
            up = True
            self._setup_node()
            self.out = self._window()
        except BaseException as e:  # noqa: B036 -- reported by run()
            self.error = f"{type(e).__name__}: {e}"[:2000]
        finally:
            if up:
                os.kill(os.getpid(), signal.SIGTERM)

    def _answers(self) -> bool:
        try:
            return _http(self.port, "/info", timeout=2.0) is not None
        except OSError:
            return False

    def _wait(self, what: str, pred, timeout: float, every=0.02) -> None:
        t0 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"{what}: not within {timeout} s")
            time.sleep(every)

    def _applied(self) -> dict:
        """{transaction hash: (ledger, close time, result code)}."""
        out = {}
        for at, arts in list(self.closes):
            seq = arts.header_entry.header.ledgerSeq
            for h, code in L.result_codes(arts).items():
                out[h] = (seq, at, code)
        return out

    def _submit_applied(self, built: list, timeout: float) -> dict:
        """Post set-up transactions until every one is applied with
        success; {hash: ledger}."""
        todo = list(built)
        t0 = time.perf_counter()
        while todo:
            retry = []
            for frame, pairs in todo:
                self._note(frame, pairs, True)
                a = _http(self.port, "/tx?blob=" + frame.envelope.to_xdr()
                          .hex())
                if a.get("status") == "TRY_AGAIN_LATER":
                    retry.append((frame, pairs))
                elif a.get("status") not in ("PENDING", "DUPLICATE"):
                    raise AssertionError(f"a set-up transaction was "
                                         f"refused: {a}")
            seen = len(self.closes)
            want = {f.content_hash() for f, _ in todo} \
                - {f.content_hash() for f, _ in retry}
            self._wait("set-up transactions applied",
                       lambda: (len(self.closes) > seen + 1 if retry else
                                want <= self._applied().keys()),
                       timeout - (time.perf_counter() - t0))
            todo = retry
        applied = self._applied()
        bad = [applied[f.content_hash()] for f, _ in built
               if applied[f.content_hash()][2] != "txSUCCESS"]
        if bad:
            raise AssertionError(f"set-up transactions failed: {bad[:3]}")
        return {f.content_hash(): applied[f.content_hash()][0]
                for f, _ in built}

    def _note(self, frame, pairs, valid: bool) -> None:
        self.sent[frame.content_hash()] = valid
        for pk, sig, h in pairs:
            self.verdicts[(pk, sig, h)] = valid

    def _setup_node(self) -> None:
        cfg = self.cfg
        app = self.app
        n, per_tx = cfg["accounts"], cfg["create_per_tx"]
        n_funders = -(-n // per_tx)
        # the accounts' creations fit one ledger under a raised tx-set
        # limit, which is set to the configuration's once they are in
        self._upgrade(n + n_funders)
        seeds = L.key_seeds("account", self.seed, n)
        fseeds = L.key_seeds("funder", self.seed, n_funders)
        pks = L.signer.public_keys(seeds + fseeds + [self.nid])
        apk, fpk, root_pk = pks[:n], pks[n:n + n_funders], pks[-1]
        root_seq = app.lm.root.get_entry(L.account_key(root_pk)) \
            .data.value.seqNum
        fund = L.build(self.nid, [(root_pk, root_seq + 1, [
            L.create_op(pk, (per_tx + 1) * L.BALANCE) for pk in fpk],
            100 * n_funders, [(self.nid, root_pk)])])
        at = self._submit_applied(fund, 120.0)
        fseq = at[fund[0][0].content_hash()] << 32
        makes = L.build(self.nid, [(fpk[j], fseq + 1, [
            L.create_op(apk[i], L.BALANCE)
            for i in range(j * per_tx, min(n, (j + 1) * per_tx))],
            100 * per_tx, [(fseeds[j], fpk[j])]) for j in range(n_funders)])
        at = self._submit_applied(makes, 120.0)
        self._upgrade(cfg["max_tx_set_size"])
        self.accounts = [(seeds[i], apk[i], at[makes[i // per_tx][0]
                                                .content_hash()] << 32)
                         for i in range(n)]
        self._sign_window()

    def _upgrade(self, max_tx_set_size: int) -> None:
        """Vote the tx-set limit over /upgrades; wait until a close has
        applied it."""
        _http(self.port, f"/upgrades?mode=set&upgradetime=0&maxtxsetsize="
                         f"{max_tx_set_size}")
        self._wait("the tx-set upgrade",
                   lambda: self.app.lm.lcl_header.maxTxSetSize
                   == max_tx_set_size, 60.0)

    def _sign_window(self) -> None:
        """The window's transactions, signed from the seed: `paced` at
        mix rate x seconds arrivals, uniform order statistics of the window
        (a Poisson process given its count), and `bursts` lists of
        burst_size, one for each close the window can hold.  Every
        transaction is a payment from an account used once; every
        corrupt_every-th carries a corrupted signature."""
        mix, rng = self.mix, np.random.default_rng(self.seed)
        n_paced = int(round(mix["rate_tx_s"] * self.seconds))
        size = int(mix.get("burst_size", 0))
        n_bursts = int(self.seconds // self.cfg["ledger_s"]) + 2 \
            if size else 0
        n_tx = n_paced + n_bursts * size
        if n_tx > len(self.accounts):
            raise ValueError(f"{n_tx} transactions, {len(self.accounts)} "
                             f"accounts: one each")
        order = rng.permutation(len(self.accounts))[:n_tx]
        dests = rng.integers(0, len(self.accounts), size=n_tx)
        amounts = rng.integers(1, 10 ** 6, size=n_tx)
        specs = []
        for i, d, a in zip(order.tolist(), dests.tolist(), amounts.tolist()):
            s, pk, seq = self.accounts[i]
            specs.append((pk, seq + 1, [L.payment_op(
                self.accounts[d][1], a)], 100, [(s, pk)]))
        built = L.build(self.nid, specs)
        every = mix["corrupt_every"]
        blobs = []
        for k, (frame, pairs) in enumerate(built):
            valid = (k + 1) % every != 0
            if not valid:
                pk, _, h = pairs[0]
                pairs = [(pk, L.corrupt(frame, 0), h)]
            self._note(frame, pairs, valid)
            blobs.append((frame.content_hash(),
                          frame.envelope.to_xdr().hex()))
        offsets = np.sort(rng.uniform(0.0, self.seconds, size=n_paced))
        self.plan_hashes = {"paced": [h for h, _ in blobs[:n_paced]],
                            "burst": []}
        bursts = []
        for b in range(n_bursts):
            chunk = blobs[n_paced + b * size:n_paced + (b + 1) * size]
            bursts.append([x for _, x in chunk])
            self.plan_hashes["burst"].append([h for h, _ in chunk])
        self.plan = {"port": self.port, "seconds": self.seconds,
                     "timeout_s": mix["timeout_s"],
                     "paced": [(float(o), x) for o, (_, x) in
                               zip(offsets.tolist(), blobs[:n_paced])],
                     "bursts": bursts,
                     "paced_workers": mix["paced_workers"],
                     "burst_clients": mix["burst_clients"]}

    def _window(self) -> dict:
        pipe = self.app.herder.admission
        trace = self.trace
        self.setup_end = time.perf_counter()
        client = subprocess.Popen(
            [sys.executable, "-m", "portbench.lib.txclient"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            cwd=str(harness.ROOT))
        t_open = time.monotonic() + self.mix["start_delay_s"]
        self.plan["t_open"] = t_open
        blob = pickle.dumps(self.plan)
        client.stdin.write(f"{len(blob)}\n".encode() + blob)
        client.stdin.flush()
        self._client = client
        time.sleep(max(0.0, t_open - time.monotonic()))
        if trace is not None:
            trace.open()
        before = harness.registry_snapshot()
        stats0 = dict(pipe.stats)
        t_close = t_open + self.seconds
        time.sleep(max(0.0, t_close - time.monotonic()))
        after = harness.registry_snapshot()
        stats1 = dict(pipe.stats)
        if trace is not None:
            trace.close()
        # every transaction due in the window: its answer, then its ledger
        self._client = None
        raw, _ = client.communicate(timeout=self.mix["timeout_s"] + 60)
        replies = pickle.loads(raw)
        accepted = {self._hash_of(k, i) for k, i, _, _, _, st in replies
                    if st == "PENDING"}
        valid = {h for h in accepted if self.sent[h]}
        t_wait = time.monotonic()
        try:
            self._wait("accepted transactions applied",
                       lambda: valid <= self._applied().keys(),
                       self.mix["confirm_wait_s"], every=0.1)
        except TimeoutError:
            pass
        # one more close, so that a valid transaction that was accepted
        # and dropped shows as never applied, not as late
        seen = len(self.closes)
        try:
            self._wait("one more close", lambda: len(self.closes) > seen,
                       2 * self.cfg["ledger_s"] + 5, every=0.1)
        except TimeoutError:
            pass
        self.replies, self.t_open, self.t_close = replies, t_open, t_close
        self.t_gave_up = time.monotonic()
        reg = harness.registry_delta(before, after)
        submitted = stats1["submitted"] - stats0["submitted"]
        # every transaction of the window carries one signature
        stats = {"submitted_signatures": submitted,
                 "admission_submitted": submitted,
                 "admission_sync_path": stats1["sync_path"]
                 - stats0["sync_path"],
                 "warmed": getattr(pipe, "_warmed", None),
                 "wait_s": time.monotonic() - t_wait}
        return {"end_to_end": self._latencies(), "registry": reg,
                "stats": stats, "setup_end": self.setup_end}

    def _hash_of(self, kind: str, i) -> bytes:
        if kind == "paced":
            return self.plan_hashes["paced"][i]
        k, j = i
        return self.plan_hashes["burst"][k][j]

    def _close_spans(self) -> list:
        """The host's time around each ledger close, as idle_gaps takes
        it: the 0.5 s on either side of each recorded close end (when a
        close began is not recorded, so it is named by its end)."""
        ends = sorted(time.time_ns() - int((time.monotonic() - at) * 1e9)
                      for at, _ in self.closes)
        return [(e - 500_000_000, e + 500_000_000,
                 "host: within 0.5 s of a ledger close") for e in ends]

    def _latencies(self) -> dict:
        """tx_confirm_p95_s over the valid transactions due in the window
        (due to the close of the ledger that applied it with success) and
        tx_reply_p95_ms over every request due in the window (due to the
        reply).  A valid transaction answered otherwise than PENDING, or
        never applied with success, and a request that got no answer from
        the node, counts as missing any limit: it is given the time from
        its due moment to the end of the wait, a lower bound of its
        latency."""
        applied = self._applied()
        confirm, reply = [], []
        for kind, i, due, sent, replied, status in self.replies:
            if not self.t_open <= due < self.t_close:
                continue
            h = self._hash_of(kind, i)
            valid = self.sent[h]
            answered = status == "PENDING" or (
                not valid and status in _STATUSES)
            reply.append((replied if answered else self.t_gave_up) - due)
            if valid:
                got = applied.get(h)
                ok = status == "PENDING" and got is not None \
                    and got[2] == "txSUCCESS"
                confirm.append((got[1] if ok else self.t_gave_up) - due)
        return {"tx_confirm_p95_s": p95(confirm) if confirm else None,
                "tx_reply_p95_ms": 1e3 * p95(reply) if reply else None}

    def release(self) -> None:
        self.app = None
        gc.collect()
        import torch
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------
    def check(self) -> dict:
        if self.error is not None or not hasattr(self, "replies"):
            return {"correct": False, "attempted": 0, "failed": 0,
                    "checks": [("run_failed", 1, 0)]}
        applied = self._applied()
        wrong_status = not_applied = bad_applied = missed = 0
        for kind, i, due, sent, replied, status in self.replies:
            h = self._hash_of(kind, i)
            got = applied.get(h)
            success = got is not None and got[2] == "txSUCCESS"
            if self.sent[h]:
                # a valid transaction: refused as invalid is a wrong
                # answer; overload and a missing answer are failures only
                wrong_status += status in _STATUSES and status not in (
                    "PENDING", "TRY_AGAIN_LATER")
                not_applied += status == "PENDING" and not success
                missed += not success
            else:
                wrong_status += status in ("DUPLICATE", "BANNED")
                bad_applied += success
        mismatches, unknown = self._reference_closes()
        checks = [("reply_status_mismatches", wrong_status, 0),
                  ("accepted_not_applied", not_applied, 0),
                  ("corrupted_applied", bad_applied, 0),
                  ("ledger_hash_mismatches", mismatches, 0),
                  ("unknown_transactions_applied", unknown, 0)]
        correct = all(v <= lim for _, v, lim in checks)
        # failed: valid transactions not applied, and corrupted ones applied
        return {"correct": correct, "attempted": len(self.replies),
                "failed": missed + bad_applied, "checks": checks}

    def _reference_closes(self) -> tuple:
        """Close the node's ledgers again with the frozen reference, each
        from its transaction set and close value as the node externalized
        them, the signatures' verdicts fixed by construction; the number
        of ledgers whose hash differs from the node's, and of transactions
        in them that the benchmark never sent."""
        from ..refcore import xdr as RX
        from ..refcore.ledger.manager import LedgerManager
        from ..refcore.ledger.txset import decode_tx_set, tx_set_envelopes
        from ..refcore.transactions.frame import TransactionFrame
        mgr = LedgerManager(self.nid)
        mgr.start_new_ledger()
        L.clear_verdicts()
        L.seed_verdicts((pk, sig, h, ok)
                        for (pk, sig, h), ok in self.verdicts.items())
        mismatches = unknown = 0
        try:
            for _, arts in self.closes:
                entry = arts.tx_entry
                gen = getattr(entry.ext, "value", None) \
                    if getattr(entry.ext, "switch", 0) else None
                blob = (gen if gen is not None else entry.txSet).to_xdr()
                tx_set = decode_tx_set(blob)
                sv = RX.StellarValue.from_xdr(
                    arts.header_entry.header.scpValue.to_xdr())
                frames = [TransactionFrame(self.nid, e)
                          for e in tx_set_envelopes(tx_set)]
                unknown += sum(1 for f in frames
                               if f.content_hash() not in self.sent)
                ref = mgr.close_ledger(frames, sv.closeTime, tx_set=tx_set,
                                       stellar_value=sv)
                mismatches += ref.header_entry.hash \
                    != arts.header_entry.hash
                if ref.header_entry.hash != arts.header_entry.hash:
                    break
        finally:
            L.clear_verdicts()
        return mismatches, unknown
