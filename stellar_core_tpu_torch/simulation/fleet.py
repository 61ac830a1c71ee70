"""Fleet harness: N real `stellar-core-tpu-torch run` processes over real TCP,
driven through scripted production events with SLO assertions.

Every production ingredient exists in isolation — TCP overlay, batched
admission with back-pressure, range-parallel catchup, `/health`, crash
bundles — and this module composes them end to end.  The
reference deployment shape is reproduced literally: a quorum of real
processes tracks a live network (`Herder`), one of them publishes
checkpoints to a shared archive (`HistoryManager`), and other nodes catch
up from that archive while the network keeps closing ledgers.

Shape of a run:

    fleet = Fleet(workdir, n_nodes=5)
    fleet.provision()                 # workdirs, configs, quorum, archive
    fleet.start()                     # N real processes via ProcessManager
    report = fleet.run(schedule=standard_schedule())
    fleet.teardown()                  # SIGTERM -> grace -> SIGKILL

The schedule is a list of events executed SEQUENTIALLY (each event must
complete before the next starts — production incidents are scripted, not
racy):

    wait-ledger / wait-s      advance time or chain height
    traffic                   set the offered tx rate (0 pauses)
    kill                      SIGKILL a validator mid-slot
    rejoin                    wipe the node, `catchup --parallel` against
                              the fleet's live archive, restart, re-track
    partition / heal          drop TCP links between groups (ban + drop
                              on both sides), later restore them
    rolling-config            roll a config change through the fleet one
                              node at a time (graceful stop -> rewrite ->
                              restart -> wait tracking)

SLOs are asserted, not just safety: zero ledger-hash divergence across
nodes, p99 close time under load, admission shed rate bounded, and
time-to-retracking after a kill under budget.  Violations (and healthy
runs) produce a replayable artifact — ``fleet-report.json`` with per-node
flight records (process logs), health timelines, the event log, and the
exact schedule/config inputs — plus whatever crash bundles the nodes
themselves wrote into the fleet's crash dir.

Everything here runs the REAL binary surface: `run`, `catchup
--parallel`, `/tx`, `/health`, `/ban`, `/droppeer` — the harness never
reaches into another process's memory.

The copy of stellar_core_tpu/simulation/fleet.py; its processes run
`python -m stellar_core_tpu_torch`.  The node configs name no ACCEL, so
every node and the rejoin's range workers take the port's default:
STPU_ACCEL where it is set, else "cuda" (a node that cannot open the card
dies at boot, and the fleet with it).  What adds to the reference is the
record of where each node process verified: every /metrics scrape's
``accel`` section (main.application.Application.accel_use), kept per
process id in ``FleetNode.accel_by_pid`` and written into the report's
``node_artifacts``.
"""

from __future__ import annotations

import json
import os
import random
import shlex
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import xdr as X
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..util import logging as slog
from ..util.clock import ClockMode, VirtualClock, monotonic_now
from ..util.fleettrace import FleetScraper, FleetTraceCollector
from ..util.process import ProcessManager
from ..util.slo import SLOTracker, default_objectives
from .loadgen import SeedAccountPool

log = slog.get("Sim")

DEFAULT_CHECKPOINT_FREQUENCY = 8   # accelerated cadence (reference: 8)


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

@dataclass
class FleetSLOs:
    """Service-level objectives the run asserts.  None disables a check
    (divergence is never disableable — a fork is a fork)."""
    max_p99_close_s: Optional[float] = 0.9      # apply work per close
    max_shed_rate: Optional[float] = 0.35       # shed / offered under load
    max_retracking_s: Optional[float] = 90.0    # kill -> tracking again
    max_roll_node_s: Optional[float] = 60.0     # per-node rolling restart
    min_sustained_tps: Optional[float] = None   # accepted tx/s (soak only)
    # fleet-wide SLO burn budget: the scraper drives an util/slo tracker
    # with every node's snapshot; a run whose burn rate exceeds the
    # budget for any objective fails.  None disables burn tracking.
    burn_budget: Optional[float] = 0.25


# ---------------------------------------------------------------------------
# one node
# ---------------------------------------------------------------------------

class FleetNode:
    """One real `stellar-core-tpu-torch run` process and its HTTP surface."""

    def __init__(self, index: int, workdir: str, secret: SecretKey,
                 peer_port: int, http_port: int):
        self.index = index
        self.workdir = workdir
        self.secret = secret
        self.peer_port = peer_port
        self.http_port = http_port
        self.conf_path = os.path.join(workdir, "node.cfg")
        self.log_path = os.path.join(workdir, "node.log")
        self.db_path = os.path.join(workdir, "node.db")
        self.bucket_dir = os.path.join(workdir, "buckets")
        self.config: Dict = {}          # the dict form of node.cfg
        self.proc_ev = None             # ProcessExitEvent while running
        self.exit_code: Optional[int] = None
        self.killed_at_seq: Optional[int] = None
        self.health_timeline: List[Tuple[float, str]] = []
        self.last_info: Optional[dict] = None
        # pid -> the latest /metrics "accel" section of that process
        self.accel_by_pid: Dict[int, dict] = {}

    def note_accel(self, metrics_doc: dict) -> None:
        """Keep the `accel` section of a /metrics document under its
        process id (a restart is a new process, a new record)."""
        accel = metrics_doc.get("accel")
        if isinstance(accel, dict) and "pid" in accel:
            self.accel_by_pid[accel["pid"]] = accel

    # -- HTTP ---------------------------------------------------------------
    def http_json(self, path: str, timeout: float = 2.0) -> Optional[dict]:
        url = f"http://127.0.0.1:{self.http_port}{path}"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return json.loads(e.read())
            except ValueError:
                return None
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def info(self) -> Optional[dict]:
        doc = self.http_json("/info")
        if doc is not None:
            self.last_info = doc.get("info")
        return self.last_info if doc is not None else None

    def health_status(self) -> str:
        doc = self.http_json("/health")
        if doc is None:
            return "unreachable"
        return doc.get("status", "unreachable")

    @property
    def running(self) -> bool:
        return self.proc_ev is not None and self.proc_ev.exit_code is None

    @property
    def node_id_hex(self) -> str:
        return self.secret.public_key.ed25519.hex()


# ---------------------------------------------------------------------------
# traffic client
# ---------------------------------------------------------------------------

class TrafficClient:
    """SeedAccountPool-keyed load over real `/tx`.

    The pool's seed-derived keys fund real accounts (root create-account
    txs through the admission pipeline like everyone else), then drive
    surge-priced payments — randomized fees, sources rotated round-robin
    so each account has at most one tx in flight per close — across the
    fleet's live nodes.  Statuses are counted client-side: `pending` is
    accepted load, `try-again-later` is shed (the back-pressure surface),
    `error` triggers a sequence-number refetch."""

    def __init__(self, fleet: "Fleet", n_accounts: int = 60, seed: int = 7):
        self.fleet = fleet
        self.pool = SeedAccountPool(n_accounts, seed=seed)
        self.rng = random.Random(seed ^ 0xF1EE7)
        self.seqs: Dict[int, int] = {}     # pool index -> last used seqNum
        self.statuses: Dict[str, int] = {}
        self.offered = 0
        self.rate_per_s = 0.0              # offered tx/s (0 = paused)
        self._accum = 0.0
        self._last_pump = monotonic_now()
        self.first_accept_t: Optional[float] = None
        self.last_accept_t: Optional[float] = None
        # a well-behaved client keeps ONE tx in flight per account (the
        # queue is replace-by-fee): account -> fleet ledger at submission,
        # released once a close has had a chance to apply it
        self._in_flight: Dict[int, int] = {}

    # -- funding ------------------------------------------------------------
    def _ledger_entry_seq(self, node: FleetNode,
                          account_id: X.AccountID) -> Optional[int]:
        key = X.LedgerKey.account(
            X.LedgerKeyAccount(accountID=account_id)).to_xdr().hex()
        doc = node.http_json(f"/getledgerentry?key={key}", timeout=5.0)
        if not doc or not doc.get("found"):
            return None
        entry = X.LedgerEntry.from_xdr(bytes.fromhex(doc["entry_xdr"]))
        return entry.data.value.seqNum

    def fund(self, timeout_s: float = 60.0) -> None:
        """Create every pool account from root, through a live node."""
        from ..testutils import build_tx, create_account_op
        fleet = self.fleet
        node = fleet.live_nodes()[0]
        root_sk = SecretKey(fleet.network_id)
        root_id = X.AccountID.ed25519(root_sk.public_key.ed25519)
        root_seq = self._ledger_entry_seq(node, root_id)
        if root_seq is None:
            raise RuntimeError("root account unreadable; node not serving")
        ops = [create_account_op(self.pool.account_id(i), 10_000_000_000)
               for i in range(self.pool.n)]
        from ..xdr.transaction import MAX_OPS_PER_TX
        deadline = monotonic_now() + timeout_s
        # one wave per root tx, externalized before the next: the queue
        # holds ONE pending tx per source account (replace-by-fee), so
        # back-to-back root txs would shed each other
        for lo in range(0, len(ops), MAX_OPS_PER_TX):
            hi = min(len(ops), lo + MAX_OPS_PER_TX)
            root_seq += 1
            frame = build_tx(fleet.network_id, root_sk, root_seq,
                             ops[lo:hi], fee=10_000)
            res = self._submit(node, frame)
            if res not in ("PENDING", "DUPLICATE"):
                raise RuntimeError(f"funding tx rejected: {res}")
            sentinel = self.pool.account_id(hi - 1)
            while monotonic_now() < deadline:
                if self._ledger_entry_seq(node, sentinel) is not None:
                    break
                time.sleep(0.2)
            else:
                raise RuntimeError(
                    f"funding wave at {lo} never externalized")
        # learn every account's creation seq (creation ledger << 32)
        for i in range(self.pool.n):
            seq = self._ledger_entry_seq(node, self.pool.account_id(i))
            if seq is None:
                raise RuntimeError(f"pool account {i} missing after fund")
            self.seqs[i] = seq

    # -- pumping ------------------------------------------------------------
    def _submit(self, node: FleetNode, frame) -> str:
        blob = frame.envelope.to_xdr().hex()
        doc = node.http_json(f"/tx?blob={blob}", timeout=12.0)
        status = (doc or {}).get("status", "UNREACHABLE")
        self.statuses[status] = self.statuses.get(status, 0) + 1
        return status

    def pump(self) -> None:
        """Offer the load accrued since the last call at `rate_per_s`."""
        from ..testutils import build_tx, native_payment_op
        now = monotonic_now()
        dt, self._last_pump = now - self._last_pump, now
        if self.rate_per_s <= 0 or not self.seqs:
            return
        self._accum = min(self._accum + dt * self.rate_per_s,
                          3.0 * self.rate_per_s)
        # each submission is a blocking HTTP round trip: bound the burst a
        # stall can accrue so one pump() never wedges the run loop
        n = min(int(self._accum), 50)
        if n <= 0:
            return
        self._accum -= n
        # route like a load balancer: prefer nodes whose /health answers
        # ok (a partitioned/stalled node is exactly what the probe is for)
        live = self.fleet.healthy_nodes() or self.fleet.live_nodes()
        if not live:
            return
        cur_seq = self.fleet.max_seq()
        # a tx submitted at ledger S externalizes in S+1 or S+2: hold the
        # account until then or the resubmission just TALs on the queue's
        # replace-by-fee rule
        self._in_flight = {i: s for i, s in self._in_flight.items()
                           if s > cur_seq - 2}
        for k in range(n):
            i = self._pick_account()
            if i is None:
                break   # every account has a tx in flight; next tick
            j = self.rng.randrange(self.pool.n)
            node = live[(self.offered + k) % len(live)]
            seq = self.seqs[i] + 1
            frame = build_tx(
                self.fleet.network_id, self.pool.secret(i), seq,
                [native_payment_op(self.pool.account_id(j), 100)],
                fee=100 + self.rng.randrange(400))   # surge-priced spread
            status = self._submit(node, frame)
            self.offered += 1
            if status == "PENDING":
                self.seqs[i] = seq
                self._in_flight[i] = cur_seq
                if self.first_accept_t is None:
                    self.first_accept_t = now
                self.last_accept_t = now
            elif status == "ERROR":
                # usually a seq desync after shedding: refetch and go on
                got = self._ledger_entry_seq(node, self.pool.account_id(i))
                if got is not None:
                    self.seqs[i] = got

    def _pick_account(self) -> Optional[int]:
        for _ in range(8):
            i = self.rng.randrange(self.pool.n)
            if i not in self._in_flight:
                return i
        free = [i for i in range(self.pool.n) if i not in self._in_flight]
        return self.rng.choice(free) if free else None

    # -- reporting ----------------------------------------------------------
    @property
    def accepted(self) -> int:
        return self.statuses.get("PENDING", 0)

    @property
    def shed(self) -> int:
        # AddResult.STATUS_TRY_AGAIN_LATER upper-cased by submit_tx
        return self.statuses.get("TRY-AGAIN-LATER", 0)

    def shed_rate(self) -> float:
        return self.shed / self.offered if self.offered else 0.0

    def report(self) -> dict:
        out = {
            "accounts": self.pool.n,
            "offered": self.offered,
            "statuses": dict(self.statuses),
            "shed_rate": round(self.shed_rate(), 4),
        }
        if self.first_accept_t is not None \
                and self.last_accept_t is not None \
                and self.last_accept_t > self.first_accept_t:
            out["accepted_tps"] = round(
                self.accepted / (self.last_accept_t - self.first_accept_t),
                1)
        return out


# ---------------------------------------------------------------------------
# schedule events
# ---------------------------------------------------------------------------

class FleetEvent:
    """One scripted production event.  ``start`` fires once; ``poll``
    returns True when the event has fully completed (the schedule is
    strictly sequential)."""

    kind = "?"

    def __init__(self, **params):
        self.params = params
        self.started_at: Optional[float] = None

    def start(self, fleet: "Fleet") -> None:
        pass

    def poll(self, fleet: "Fleet") -> bool:
        return True

    def describe(self) -> dict:
        return {"kind": self.kind, **self.params}


class WaitLedger(FleetEvent):
    kind = "wait-ledger"

    def poll(self, fleet):
        return fleet.max_seq() >= self.params["seq"]


class WaitSeconds(FleetEvent):
    kind = "wait-s"

    def poll(self, fleet):
        return monotonic_now() - self.started_at >= self.params["s"]


class SetTraffic(FleetEvent):
    kind = "traffic"

    def start(self, fleet):
        fleet.client.rate_per_s = float(self.params["rate_per_s"])


class KillNode(FleetEvent):
    kind = "kill"

    def start(self, fleet):
        node = fleet.nodes[self.params["node"]]
        node.killed_at_seq = fleet.max_seq()
        fleet.kill_node(node.index)
        fleet.note(f"killed node {node.index} at fleet ledger "
                   f"{node.killed_at_seq} (SIGKILL mid-slot)")

    def poll(self, fleet):
        return not fleet.nodes[self.params["node"]].running


class RejoinNode(FleetEvent):
    """Wipe the node's state, replay the fleet's live archive with
    `catchup --parallel`, restart the process, and wait until it tracks
    the live network again.  Measures kill -> tracking wall seconds."""

    kind = "rejoin"

    def __init__(self, **params):
        super().__init__(**params)
        self._phase = "wait-archive"
        self._catchup_ev = None
        self._restarted_at: Optional[float] = None

    def start(self, fleet):
        self._node = fleet.nodes[self.params["node"]]
        self._workers = int(self.params.get("parallel", 2))

    def poll(self, fleet):
        node = self._node
        if self._phase == "wait-archive":
            # the archive must cover the kill point before a catchup can
            # bridge the gap (the writer keeps publishing meanwhile)
            has_seq = fleet.archive_tip()
            need = (node.killed_at_seq or 0)
            if has_seq is None or has_seq < need:
                return False
            fleet.note(f"rejoin node {node.index}: archive tip {has_seq} "
                       f"covers kill seq {need}; wiping state and starting "
                       f"catchup --parallel {self._workers}")
            fleet.wipe_node_state(node.index)
            self._catchup_ev = fleet.start_catchup(node.index,
                                                   self._workers)
            self._phase = "catchup"
            return False
        if self._phase == "catchup":
            if self._catchup_ev.exit_code is None:
                return False
            if self._catchup_ev.exit_code != 0:
                fleet.violation(
                    f"rejoin node {node.index}: catchup --parallel exited "
                    f"{self._catchup_ev.exit_code} (see "
                    f"{node.workdir}/catchup.log)")
                return True
            fleet.note(f"rejoin node {node.index}: parallel catchup "
                       "complete; restarting")
            # a restarted node syncs from its peers (FORCE_SCP only
            # bootstraps a genesis network)
            node.config["FORCE_SCP"] = False
            fleet.write_config(node.index)
            fleet.start_node(node.index)
            self._restarted_at = monotonic_now()
            self._phase = "retrack"
            return False
        # retrack: tracking again and within a slot of the fleet tip
        info = node.info()
        if info and info.get("state") == "tracking" \
                and info["ledger"]["num"] >= fleet.max_seq() - 2:
            secs = monotonic_now() - self._restarted_at
            total = monotonic_now() - self.started_at
            fleet.metrics["retracking_s"] = round(secs, 1)
            fleet.metrics["kill_to_retracking_s"] = round(total, 1)
            fleet.note(f"rejoin node {node.index}: TRACKING again at "
                       f"ledger {info['ledger']['num']} "
                       f"({secs:.1f}s after restart, {total:.1f}s after "
                       "the rejoin began)")
            return True
        return False


class Partition(FleetEvent):
    """Drop the TCP links between node groups and keep them down: both
    sides ban each other (auth-time refusal beats redial) and the live
    connections are dropped through the admin surface."""

    kind = "partition"

    def start(self, fleet):
        groups: List[List[int]] = self.params["groups"]
        fleet.partition_pairs = []
        for gi, ga in enumerate(groups):
            for gb in groups[gi + 1:]:
                for a in ga:
                    for b in gb:
                        fleet.partition_pairs.append((a, b))
        for a, b in fleet.partition_pairs:
            fleet.sever_link(a, b)
        fleet.note(f"partitioned overlay into {groups} "
                   f"({len(fleet.partition_pairs)} links severed)")


class Heal(FleetEvent):
    kind = "heal"

    def start(self, fleet):
        for a, b in fleet.partition_pairs:
            fleet.restore_link(a, b)
        fleet.note(f"healed partition ({len(fleet.partition_pairs)} links "
                   "restored)")
        fleet.partition_pairs = []

    def poll(self, fleet):
        # healed means: every live node tracks again within the timeout
        timeout = float(self.params.get("timeout_s", 60.0))
        lagging = []
        for node in fleet.live_nodes():
            info = node.info()
            if not info or info.get("state") != "tracking" \
                    or info["ledger"]["num"] < fleet.max_seq() - 3:
                lagging.append(node.index)
        if not lagging:
            fleet.note("partition healed: every node tracking again")
            return True
        if monotonic_now() - self.started_at > timeout:
            fleet.violation(
                f"heal: nodes {lagging} never re-tracked within "
                f"{timeout:.0f}s")
            return True
        return False


class RollingConfig(FleetEvent):
    """Roll a config change through the fleet one node at a time:
    graceful stop, rewrite config with the overrides, restart, wait for
    tracking — the next node only rolls once the previous one is back."""

    kind = "rolling-config"

    def __init__(self, **params):
        super().__init__(**params)
        self._queue: List[int] = []
        self._current: Optional[int] = None
        self._phase = "idle"
        self._node_t0 = 0.0

    def start(self, fleet):
        self._queue = list(self.params.get(
            "nodes", [n.index for n in fleet.nodes]))
        fleet.metrics.setdefault("roll_node_s", {})

    def poll(self, fleet):
        timeout = float(self.params.get("per_node_timeout_s", 60.0))
        if self._phase == "idle":
            if not self._queue:
                fleet.note("rolling config change complete")
                return True
            self._current = self._queue.pop(0)
            self._node_t0 = monotonic_now()
            node = fleet.nodes[self._current]
            fleet.note(f"rolling node {self._current}: graceful stop")
            fleet.stop_node(self._current)
            self._phase = "stopping"
            return False
        node = fleet.nodes[self._current]
        if self._phase == "stopping":
            if node.running:
                return False
            node.config.update(self.params["overrides"])
            node.config["FORCE_SCP"] = False
            fleet.write_config(self._current)
            fleet.start_node(self._current)
            self._phase = "restarting"
            return False
        # restarting: wait tracking (or per-node timeout -> violation)
        info = node.info()
        if info and info.get("state") == "tracking" \
                and info["ledger"]["num"] >= fleet.max_seq() - 2:
            secs = round(monotonic_now() - self._node_t0, 1)
            fleet.metrics["roll_node_s"][str(self._current)] = secs
            fleet.note(f"rolling node {self._current}: tracking again "
                       f"with new config ({secs}s)")
            self._phase = "idle"
            return False
        if monotonic_now() - self._node_t0 > timeout:
            fleet.violation(
                f"rolling-config: node {self._current} never re-tracked "
                f"within {timeout:.0f}s")
            self._phase = "idle"
            return False
        return False


_EVENT_KINDS = {
    "wait-ledger": WaitLedger,
    "wait-s": WaitSeconds,
    "traffic": SetTraffic,
    "kill": KillNode,
    "rejoin": RejoinNode,
    "partition": Partition,
    "heal": Heal,
    "rolling-config": RollingConfig,
}


_REQUIRED_PARAMS = {
    "wait-ledger": ("seq",),
    "wait-s": ("s",),
    "traffic": ("rate_per_s",),
    "kill": ("node",),
    "rejoin": ("node",),
    "partition": ("groups",),
    "heal": (),
    "rolling-config": ("overrides",),
}


def parse_schedule(entries: List[dict],
                   n_nodes: Optional[int] = None) -> List[FleetEvent]:
    """JSON-friendly schedule -> event objects (the `fleet --schedule`
    file format; see README §Fleet soak).  Schedules are user input:
    missing required params — and, when `n_nodes` is known, node indices
    out of range — fail HERE, with the entry index, not as a
    KeyError/IndexError mid-soak after the fleet booted."""
    events = []
    for idx, entry in enumerate(entries):
        entry = dict(entry)
        kind = entry.pop("kind", None)
        cls = _EVENT_KINDS.get(kind)
        if cls is None:
            raise ValueError(f"schedule entry {idx}: unknown fleet event "
                             f"kind {kind!r} (know: {sorted(_EVENT_KINDS)})")
        missing = [p for p in _REQUIRED_PARAMS[kind] if p not in entry]
        if missing:
            raise ValueError(f"schedule entry {idx} ({kind}): missing "
                             f"required param(s) {missing}")
        if n_nodes is not None:
            named = []
            if "node" in entry:
                named.append(entry["node"])
            for group in entry.get("groups", []):
                named.extend(group)
            named.extend(entry.get("nodes", []))
            bad = [n for n in named
                   if not isinstance(n, int) or not 0 <= n < n_nodes]
            if bad:
                raise ValueError(
                    f"schedule entry {idx} ({kind}): node index(es) {bad} "
                    f"out of range for a {n_nodes}-node fleet")
        events.append(cls(**entry))
    return events


def standard_schedule(n_nodes: int = 5, kill_node: int = 2,
                      traffic_rate: float = 25.0,
                      partition_s: float = 6.0,
                      roll_nodes: Optional[List[int]] = None) -> List[dict]:
    """The acceptance-bar production-event script: sustained traffic
    through a kill + parallel-catchup rejoin, an overlay partition +
    heal, and a rolling config change.  The minority side of the
    partition is the last (n-1)//2 nodes, so the majority side always
    still meets the n//2+1 threshold (even fleet sizes included) and
    node 0 keeps closing ledgers and publishing checkpoints
    throughout."""
    minority = [i for i in range(n_nodes)
                if i >= n_nodes - ((n_nodes - 1) // 2)]
    majority = [i for i in range(n_nodes) if i not in minority]
    return [
        {"kind": "traffic", "rate_per_s": traffic_rate},
        {"kind": "wait-ledger", "seq": 6},
        {"kind": "kill", "node": kill_node},
        {"kind": "rejoin", "node": kill_node, "parallel": 2},
        {"kind": "partition", "groups": [majority, minority]},
        {"kind": "wait-s", "s": partition_s},
        {"kind": "heal"},
        {"kind": "rolling-config",
         "overrides": {"ADMISSION_BATCH_SIZE": 128, "LOG_LEVEL": "WARNING"},
         "nodes": roll_nodes if roll_nodes is not None
         else list(range(n_nodes))},
        {"kind": "wait-s", "s": 3.0},
    ]


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class Fleet:
    def __init__(self, workdir: str, n_nodes: int = 5,
                 passphrase: str = "fleet soak net",
                 checkpoint_frequency: int = DEFAULT_CHECKPOINT_FREQUENCY,
                 threshold: Optional[int] = None,
                 n_accounts: int = 60,
                 slos: Optional[FleetSLOs] = None,
                 native_close_differential: int = 8,
                 python: str = sys.executable):
        self.workdir = os.path.abspath(workdir)
        self.n_nodes = n_nodes
        self.passphrase = passphrase
        self.network_id = sha256(passphrase.encode())
        self.checkpoint_frequency = checkpoint_frequency
        # simple majority: any two quorums intersect (t + t > n) while a
        # minority partition side stalls instead of forking
        self.threshold = threshold or (n_nodes // 2 + 1)
        # every soak carries native-live-close differential spot-checks
        # each node's Nth close also runs the Python oracle
        # on a scratch copy and fail-stops with a crash bundle on any
        # divergence — a silent C-engine regression cannot survive a soak.
        # 0 disables (pure-Python closes keep the cadence key harmless).
        self.native_close_differential = max(0, native_close_differential)
        self.archive_dir = os.path.join(self.workdir, "archive")
        self.crash_dir = os.path.join(self.workdir, "crash-bundles")
        self.clock = VirtualClock(ClockMode.REAL_TIME)
        self.pm = ProcessManager(self.clock, max_concurrent=4 * n_nodes)
        self.nodes: List[FleetNode] = []
        self.client = TrafficClient(self, n_accounts=n_accounts)
        self.slos = slos or FleetSLOs()
        self.python = python
        self.hash_by_seq: Dict[int, Dict[int, str]] = {}
        self.events_log: List[dict] = []
        self.violations: List[str] = []
        self.metrics: Dict = {}
        self.partition_pairs: List[Tuple[int, int]] = []
        self._t0 = monotonic_now()
        self._last_sample = 0.0
        self._last_trace_poll = 0.0
        self._archive_tip_cache: Tuple[float, Optional[int]] = (0.0, None)
        # observability plane: incremental /tracespans collection into
        # ONE merged cross-node Chrome trace, plus a /metrics scraper
        # feeding SLO curves and a fleet-wide burn tracker
        self.trace_collector = FleetTraceCollector()
        self.slo_tracker: Optional[SLOTracker] = None
        if self.slos.burn_budget is not None:
            self.slo_tracker = SLOTracker(
                default_objectives(
                    close_p99_s=self.slos.max_p99_close_s or 2.0,
                    budget=self.slos.burn_budget),
                source="fleet")
        self.scraper: Optional[FleetScraper] = None

    # -- provisioning -------------------------------------------------------
    @staticmethod
    def _free_ports(n: int) -> List[int]:
        import socket as pysock
        socks, ports = [], []
        for _ in range(n):
            s = pysock.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return ports

    def provision(self) -> None:
        """Per-node workdirs, deterministic validator keys, the shared
        quorum set, and one shared file archive (node 0 is the single
        writer — every node reads it for catchup)."""
        os.makedirs(self.archive_dir, exist_ok=True)
        os.makedirs(self.crash_dir, exist_ok=True)
        ports = self._free_ports(2 * self.n_nodes)
        peer_ports, http_ports = (ports[:self.n_nodes],
                                  ports[self.n_nodes:])
        secrets = [SecretKey(sha256(b"fleet node %d " % i
                                    + self.network_id))
                   for i in range(self.n_nodes)]
        validators = [s.public_key.to_strkey() for s in secrets]
        for i in range(self.n_nodes):
            nd = os.path.join(self.workdir, f"node-{i}")
            os.makedirs(nd, exist_ok=True)
            node = FleetNode(i, nd, secrets[i], peer_ports[i],
                             http_ports[i])
            peers = [f"127.0.0.1:{peer_ports[j]}"
                     for j in range(self.n_nodes) if j != i]
            node.config = {
                "NETWORK_PASSPHRASE": self.passphrase,
                "NODE_SEED": secrets[i].to_strkey_seed(),
                "NODE_IS_VALIDATOR": True,
                "FORCE_SCP": True,     # genesis bootstrap; restarts clear it
                "PEER_PORT": node.peer_port,
                "HTTP_PORT": node.http_port,
                "KNOWN_PEERS": peers,
                "TARGET_PEER_CONNECTIONS": self.n_nodes + 2,
                "DATABASE": node.db_path,
                "BUCKET_DIR_PATH": node.bucket_dir,
                "ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING": True,
                "CHECKPOINT_FREQUENCY": self.checkpoint_frequency,
                # live-close differential cadence rides in every node
                # config, so every soak spot-checks the native engine
                "NATIVE_CLOSE_DIFFERENTIAL": self.native_close_differential,
                # observability plane: stable node name on every span,
                # flight event and phase mark, plus in-process SLO burn
                # evaluation on a 1s cadence
                "NODE_NAME": f"node-{i}",
                "SLO_EVAL_CADENCE_S": 1.0,
                "LOG_LEVEL": "INFO",
                "QUORUM_SET": {"THRESHOLD": self.threshold,
                               "VALIDATORS": validators},
                # one shared archive every validator publishes to and
                # catches up from.  Concurrent writers are safe: the
                # objects are content-identical at a given checkpoint
                # (same headers, same buckets) and FileHistoryArchive
                # writes are atomic with pid-unique tmp files, so a
                # reader never observes a torn object.
                "HISTORY": {"fleet": {"get": self.archive_dir,
                                      "put": self.archive_dir}},
            }
            self.nodes.append(node)
            self.write_config(i)
        self.note(f"provisioned {self.n_nodes} nodes "
                  f"(threshold {self.threshold}, checkpoint frequency "
                  f"{self.checkpoint_frequency}, archive {self.archive_dir})")

    def write_config(self, index: int) -> None:
        """Render the node's config dict as the TOML subset node.cfg."""
        node = self.nodes[index]
        cfg = node.config
        lines = []
        for key, val in cfg.items():
            if key in ("QUORUM_SET", "HISTORY"):
                continue
            lines.append(f"{key} = {json.dumps(val)}")
        q = cfg["QUORUM_SET"]
        lines.append("\n[QUORUM_SET]")
        lines.append(f"THRESHOLD = {q['THRESHOLD']}")
        lines.append(f"VALIDATORS = {json.dumps(q['VALIDATORS'])}")
        for name, spec in cfg["HISTORY"].items():
            lines.append(f"\n[HISTORY.{name}]")
            for k, v in spec.items():
                lines.append(f"{k} = {json.dumps(v)}")
        with open(node.conf_path, "w") as f:
            f.write("\n".join(lines) + "\n")

    # -- process control ----------------------------------------------------
    def _run_cmdline(self, node: FleetNode) -> str:
        return " ".join(shlex.quote(a) for a in [
            self.python, "-m", "stellar_core_tpu_torch", "run",
            "--conf", node.conf_path])

    def start_node(self, index: int) -> None:
        node = self.nodes[index]
        if node.running:
            return
        node.exit_code = None

        def on_exit(code: int, node=node) -> None:
            node.exit_code = code
            log.info("fleet node %d exited %d", node.index, code)

        node.proc_ev = self.pm.run_command(
            self._run_cmdline(node), on_exit, output_path=node.log_path)
        self.crank()

    def start(self) -> None:
        # children inherit the env: node crashes dump bundles into the
        # fleet's artifact dir (restored on teardown)
        self._prev_crash_dir = os.environ.get("STPU_CRASH_DIR")
        os.environ["STPU_CRASH_DIR"] = self.crash_dir
        for i in range(self.n_nodes):
            self.start_node(i)
        self.scraper = FleetScraper(
            {f"node-{i}": self._metrics_fetcher(self.nodes[i])
             for i in range(self.n_nodes)},
            tracker=self.slo_tracker,
            # per-node regression verdicts in fleet-report.json; bound
            # ring memory against nodes that leave the fleet for good
            anomaly=True, retention_s=600.0).start()
        self.note(f"launched {self.n_nodes} run processes")

    def _metrics_fetcher(self, node: FleetNode):
        """Scraper fetcher: the node's flat metric registry snapshot;
        raises when the node is unreachable (killed / mid-restart) so
        the sweep counts it as a scrape error."""
        def fetch() -> dict:
            doc = node.http_json("/metrics", timeout=5.0)
            if doc is None:
                raise RuntimeError(
                    f"node {node.index} /metrics unreachable")
            node.note_accel(doc.get("metrics", {}))
            return doc.get("metrics", {}).get("registry", {})
        return fetch

    def kill_node(self, index: int) -> None:
        """SIGKILL — the crash shape (rejoin brings it back)."""
        node = self.nodes[index]
        if node.proc_ev is not None and node.proc_ev.exit_code is None \
                and node.proc_ev.proc is not None:
            node.proc_ev.proc.kill()
        self.crank()

    def stop_node(self, index: int, grace_s: float = 8.0) -> None:
        """Graceful stop with SIGTERM -> SIGKILL escalation."""
        node = self.nodes[index]
        if node.proc_ev is not None:
            self.pm.stop(node.proc_ev, grace_s=grace_s)
        self.crank()

    def wipe_node_state(self, index: int) -> None:
        """Drop a dead node's durable state (db + wal + buckets) so the
        rejoin replays the fleet's archive from scratch — the 'new node
        joins the network' production shape."""
        import shutil
        node = self.nodes[index]
        for suffix in ("", "-wal", "-shm"):
            try:
                os.unlink(node.db_path + suffix)
            except FileNotFoundError:
                pass
        shutil.rmtree(node.bucket_dir, ignore_errors=True)
        shutil.rmtree(os.path.join(node.workdir, "catchup-par"),
                      ignore_errors=True)

    def start_catchup(self, index: int, workers: int):
        """`catchup --parallel N` against the fleet's live archive, as a
        real subprocess (its log is part of the flight record)."""
        node = self.nodes[index]
        cmd = " ".join(shlex.quote(a) for a in [
            self.python, "-m", "stellar_core_tpu_torch", "catchup",
            "--conf", node.conf_path, "--parallel", str(workers)])
        return self.pm.run_command(
            cmd, lambda code: None,
            output_path=os.path.join(node.workdir, "catchup.log"))

    def teardown(self, grace_s: float = 8.0) -> None:
        if self.scraper is not None:
            self.scraper.stop()
        self.pm.shutdown(grace_s=grace_s)
        prev = getattr(self, "_prev_crash_dir", None)
        if prev is None:
            os.environ.pop("STPU_CRASH_DIR", None)
        else:
            os.environ["STPU_CRASH_DIR"] = prev

    # -- overlay surgery ----------------------------------------------------
    def sever_link(self, a: int, b: int) -> None:
        """Drop the TCP link a<->b and keep it down: mutual bans (refused
        at auth time, beating the redial timer) plus dropping the live
        connections — all through the real admin surface."""
        na, nb = self.nodes[a], self.nodes[b]
        na.http_json(f"/ban?node={nb.node_id_hex}")
        nb.http_json(f"/ban?node={na.node_id_hex}")
        na.http_json(f"/droppeer?node={nb.node_id_hex}")
        nb.http_json(f"/droppeer?node={na.node_id_hex}")

    def restore_link(self, a: int, b: int) -> None:
        na, nb = self.nodes[a], self.nodes[b]
        na.http_json(f"/unban?node={nb.node_id_hex}")
        nb.http_json(f"/unban?node={na.node_id_hex}")

    # -- observation --------------------------------------------------------
    def crank(self) -> None:
        self.clock.crank()

    def live_nodes(self) -> List[FleetNode]:
        return [n for n in self.nodes if n.running]

    def healthy_nodes(self) -> List[FleetNode]:
        """Nodes whose most recent /health sample answered ok — the
        load-balancer routing set."""
        return [n for n in self.nodes if n.running and n.health_timeline
                and n.health_timeline[-1][1] == "ok"]

    def max_seq(self) -> int:
        return max((n.last_info["ledger"]["num"] for n in self.nodes
                    if n.last_info), default=0)

    def archive_tip(self) -> Optional[int]:
        """The shared archive's HAS currentLedger (cached ~1s — the HAS
        is a tiny JSON file but the run loop is hot)."""
        now = monotonic_now()
        at, tip = self._archive_tip_cache
        if now - at < 1.0:
            return tip
        tip = None
        try:
            with open(os.path.join(
                    self.archive_dir,
                    ".well-known/stellar-history.json")) as f:
                tip = json.load(f).get("currentLedger")
        except (OSError, ValueError):
            pass
        self._archive_tip_cache = (now, tip)
        return tip

    def sample(self) -> None:
        """Poll every node's /info + /health into the timelines; collect
        (seq -> hash) pairs for the divergence proof."""
        t = round(monotonic_now() - self._t0, 1)
        for node in self.nodes:
            if not node.running:
                node.health_timeline.append((t, "down"))
                continue
            info = node.info()
            node.health_timeline.append((t, node.health_status()))
            if info:
                seq = info["ledger"]["num"]
                h = info["ledger"]["hash"]
                seen = self.hash_by_seq.setdefault(seq, {})
                prev = seen.get(node.index)
                if prev is not None and prev != h:
                    self.violation(
                        f"node {node.index} changed its hash for ledger "
                        f"{seq}: {prev[:16]} -> {h[:16]}")
                seen[node.index] = h

    def poll_traces(self) -> int:
        """Incremental /tracespans sweep over live nodes into the trace
        collector; returns new marks+spans folded in.  An unreachable
        node keeps what it already contributed."""
        got = 0
        for node in self.live_nodes():
            def fetch(path: str, node=node) -> dict:
                doc = node.http_json(path, timeout=5.0)
                if doc is None:
                    raise RuntimeError(
                        f"node {node.index} {path} unreachable")
                return doc
            try:
                got += self.trace_collector.poll(
                    f"node-{node.index}", fetch)
            except Exception:  # corelint: disable=exception-hygiene -- a killed node must not stop the sweep; its already-collected spans stay in the merge
                continue
        return got

    def note(self, msg: str) -> None:
        t = round(monotonic_now() - self._t0, 1)
        self.events_log.append({"t_s": t, "event": msg})
        log.info("[%.1fs] %s", t, msg)

    def violation(self, msg: str) -> None:
        self.violations.append(msg)
        self.note(f"SLO VIOLATION: {msg}")

    # -- readiness ----------------------------------------------------------
    def wait_all_healthy(self, timeout_s: float = 60.0) -> None:
        deadline = monotonic_now() + timeout_s
        while monotonic_now() < deadline:
            self.crank()
            self.sample()
            dead = [n.index for n in self.nodes
                    if n.proc_ev is not None and n.proc_ev.exit_code
                    not in (None, 0)]
            if dead:
                raise RuntimeError(
                    f"nodes {dead} died during boot (see node.log)")
            if all(n.health_timeline and n.health_timeline[-1][1] == "ok"
                   for n in self.nodes):
                self.note("all nodes healthy (every /health answers ok)")
                return
            time.sleep(0.3)
        states = {n.index: (n.health_timeline[-1][1]
                            if n.health_timeline else "?")
                  for n in self.nodes}
        raise RuntimeError(f"fleet never became healthy: {states}")

    # -- the run loop -------------------------------------------------------
    def run(self, schedule: List[dict],
            settle_ledgers: int = 3,
            timeout_s: float = 600.0) -> dict:
        """Execute the event schedule sequentially against the live
        fleet while traffic pumps and samples accumulate, then evaluate
        the SLOs and write the replayable report."""
        self._schedule_input = list(schedule)
        events = parse_schedule(schedule, n_nodes=self.n_nodes)
        deadline = monotonic_now() + timeout_s
        idx = 0
        current: Optional[FleetEvent] = None
        while monotonic_now() < deadline:
            self.crank()
            self.client.pump()
            now = monotonic_now()
            if now - self._last_sample >= 0.25:
                self._last_sample = now
                self.sample()
            if now - self._last_trace_poll >= 1.0:
                self._last_trace_poll = now
                self.poll_traces()
            if current is None:
                if idx >= len(events):
                    break
                current = events[idx]
                current.started_at = now
                self.note(f"event {idx}: {current.describe()}")
                current.start(self)
            if current.poll(self):
                idx += 1
                current = None
            time.sleep(0.05)
        else:
            self.violation(f"schedule never completed within {timeout_s}s "
                           f"(stalled at event {idx})")
        # settle: stop traffic, let the tail externalize so the final
        # divergence sweep compares settled hashes
        self.client.rate_per_s = 0.0
        settle_to = self.max_seq() + settle_ledgers
        settle_deadline = monotonic_now() + 30.0
        while monotonic_now() < settle_deadline \
                and self.max_seq() < settle_to:
            self.crank()
            self.sample()
            time.sleep(0.2)
        return self.finalize()

    # -- verdicts -----------------------------------------------------------
    def check_divergence(self) -> int:
        """Zero ledger-hash divergence: every (seq, node) sample must
        agree per seq.  Returns the number of seqs compared."""
        compared = 0
        for seq in sorted(self.hash_by_seq):
            hashes = set(self.hash_by_seq[seq].values())
            if len(self.hash_by_seq[seq]) > 1:
                compared += 1
            if len(hashes) > 1:
                self.violation(
                    f"HASH DIVERGENCE at ledger {seq}: "
                    + ", ".join(f"node {n}={h[:16]}" for n, h in
                                sorted(self.hash_by_seq[seq].items())))
        return compared

    def p99_close_s(self) -> Optional[float]:
        """Worst per-node ledger.ledger.close p99 from /metrics."""
        worst = None
        for node in self.live_nodes():
            doc = node.http_json("/metrics", timeout=5.0)
            if not doc:
                continue
            node.note_accel(doc.get("metrics", {}))
            reg = doc.get("metrics", {}).get("registry", {})
            row = reg.get("ledger.ledger.close")
            if row and "p99_s" in row:
                worst = max(worst or 0.0, row["p99_s"])
        return worst

    def native_close_counters(self) -> Dict[str, int]:
        """Fleet-wide native live-close evidence from /metrics: closes
        driven by the C engine, differential spot-checks actually run
        (the NATIVE_CLOSE_DIFFERENTIAL cadence provisioned into every
        node), and per-close Python fallbacks.  A divergence never shows
        up here — the node fail-stops with a crash bundle and the soak's
        crash-dir/violation machinery reports it."""
        out = {"native_closes": 0, "native_differential_checks": 0,
               "native_fallbacks": 0}
        for node in self.live_nodes():
            doc = node.http_json("/metrics", timeout=5.0)
            if not doc:
                continue
            reg = doc.get("metrics", {}).get("registry", {})
            for key, name in (("native_closes", "ledger.native.closes"),
                              ("native_differential_checks",
                               "ledger.native.differential-checks"),
                              ("native_fallbacks",
                               "ledger.native.fallbacks")):
                row = reg.get(name)
                if row and isinstance(row.get("count"), int):
                    out[key] += row["count"]
        return out

    def finalize(self) -> dict:
        # drain the observability plane while nodes are still up: one
        # last metric sweep + trace poll so the merged artifact carries
        # the run's tail
        if self.scraper is not None:
            self.scraper.stop()
            self.scraper.sweep()
        self.poll_traces()
        compared = self.check_divergence()
        slo = self.slos
        p99 = self.p99_close_s()
        if self.native_close_differential:
            self.metrics.update(self.native_close_counters())
        shed = self.client.shed_rate()
        if slo.max_p99_close_s is not None and p99 is not None \
                and p99 > slo.max_p99_close_s:
            self.violation(f"p99 close time {p99:.3f}s exceeds "
                           f"{slo.max_p99_close_s}s")
        if slo.max_shed_rate is not None and shed > slo.max_shed_rate:
            self.violation(f"admission shed rate {shed:.2%} exceeds "
                           f"{slo.max_shed_rate:.0%}")
        retr = self.metrics.get("retracking_s")
        if slo.max_retracking_s is not None and retr is not None \
                and retr > slo.max_retracking_s:
            self.violation(f"time-to-retracking {retr}s exceeds "
                           f"{slo.max_retracking_s}s")
        for n_idx, secs in self.metrics.get("roll_node_s", {}).items():
            if slo.max_roll_node_s is not None \
                    and secs > slo.max_roll_node_s:
                self.violation(f"rolling restart of node {n_idx} took "
                               f"{secs}s (> {slo.max_roll_node_s}s)")
        tps = self.client.report().get("accepted_tps")
        if slo.min_sustained_tps is not None and tps is not None \
                and tps < slo.min_sustained_tps:
            self.violation(f"sustained TPS {tps} below "
                           f"{slo.min_sustained_tps}")
        if self.slo_tracker is not None \
                and not self.slo_tracker.within_budget():
            for o in self.slo_tracker.objectives:
                if self.slo_tracker.burning(o.name):
                    rate = self.slo_tracker.burn_rate(o.name)
                    self.violation(
                        f"SLO burn: objective {o.name} burned "
                        f"{rate:.0%} of its recent windows "
                        f"(budget {o.budget:.0%})")
        trace_path = os.path.join(self.workdir, "fleet-trace.json")
        trace_events = self.trace_collector.write_merged_trace(trace_path)
        self.note(f"merged cross-node trace written to {trace_path} "
                  f"({trace_events} events from "
                  f"{len(self.trace_collector.nodes())} nodes)")
        report = {
            "passed": not self.violations,
            "violations": list(self.violations),
            "nodes": self.n_nodes,
            "threshold": self.threshold,
            "checkpoint_frequency": self.checkpoint_frequency,
            "wall_s": round(monotonic_now() - self._t0, 1),
            "max_ledger": self.max_seq(),
            "divergence_seqs_compared": compared,
            "p99_close_s": p99,
            "traffic": self.client.report(),
            "metrics": self.metrics,
            "archive_tip": self.archive_tip(),
            "observability": {
                "trace_path": trace_path,
                "trace_events": trace_events,
                "trace_nodes": self.trace_collector.nodes(),
                "clock_offsets_s": self.trace_collector.align_offsets(),
                "scraper": (self.scraper.report()
                            if self.scraper is not None else None),
            },
            "schedule": getattr(self, "_schedule_input", []),
            "events": self.events_log,
            "node_artifacts": [
                {"index": n.index,
                 "log": n.log_path,
                 "conf": n.conf_path,
                 "final_info": n.last_info,
                 "accel": list(n.accel_by_pid.values()),
                 "health_timeline": n.health_timeline[-200:]}
                for n in self.nodes],
            "crash_dir": self.crash_dir,
        }
        path = os.path.join(self.workdir, "fleet-report.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        report["report_path"] = path
        self.note(f"fleet report written to {path} "
                  f"({'PASS' if report['passed'] else 'FAIL'})")
        return report


# ---------------------------------------------------------------------------
# one-call soak (the CLI entry point)
# ---------------------------------------------------------------------------

def run_fleet_soak(workdir: str, n_nodes: int = 5,
                   schedule: Optional[List[dict]] = None,
                   traffic_rate: float = 25.0,
                   n_accounts: int = 60,
                   slos: Optional[FleetSLOs] = None,
                   native_close_differential: int = 8,
                   timeout_s: float = 600.0) -> dict:
    """Provision, boot, fund, run the schedule, tear down.  Returns the
    fleet report (never leaks processes — teardown escalates).  Every
    soak provisions NATIVE_CLOSE_DIFFERENTIAL into the node configs so
    live closes carry C-vs-Python spot-checks (0 disables)."""
    if schedule is None:
        schedule = standard_schedule(n_nodes=n_nodes,
                                     traffic_rate=traffic_rate)
    # validate user input (incl. node indices) BEFORE booting anything
    parse_schedule(schedule, n_nodes=n_nodes)
    fleet = Fleet(workdir, n_nodes=n_nodes, n_accounts=n_accounts,
                  slos=slos,
                  native_close_differential=native_close_differential)
    fleet.provision()
    try:
        fleet.start()
        fleet.wait_all_healthy(timeout_s=90.0)
        fleet.client.fund()
        fleet.note(f"traffic pool funded ({n_accounts} accounts)")
        return fleet.run(schedule, timeout_s=timeout_s)
    finally:
        fleet.teardown()
