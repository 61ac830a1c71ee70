"""Simulation — N full in-process nodes on one shared VirtualClock.

Reference: src/simulation/Simulation.{h,cpp} — addNode, addPendingConnection,
startAllNodes, crankUntil/crankForAtLeast, Topologies (src/simulation/
Topologies.cpp — core, cycle, hierarchical); nodes wired OVER_LOOPBACK.
This is THE deterministic multi-node test pattern (SURVEY.md §4): no
threads, no sockets, no wall clock — every message delivery is a posted
clock action, every timeout is virtual.

Transport is the real overlay over LoopbackPeer pairs (reference:
Simulation::OVER_LOOPBACK + LoopbackPeerConnection): every SimNode runs a
full OverlayManager, so consensus traffic traverses the authenticated
handshake, flow-control windows, pull-mode tx flooding (advert/demand) and
hash-addressed item fetch — the same machinery production uses.
Partitions sever the loopback connections; healing redials them.

The copy of stellar_core_tpu/simulation/simulation.py.  What it adds is
where signatures verify: ``Simulation(accel=..., accel_device=...)``
(off by default, as in the reference) is what a node's archive catchup
and, through ``SimNode.enable_admission``, its admission pipeline take —
accel on with ``accel_device`` None is the card (an error where CUDA is
not available), "cpu" the kernels' plain versions.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

from .. import xdr as X
from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..herder.herder import Herder, HerderState
from ..herder.upgrades import Upgrades
from ..ledger.manager import LedgerManager
from ..main.status import StatusManager
from ..overlay.overlay_manager import OverlayManager
from ..overlay.peer import make_loopback_pair
from ..scp.quorum import qset_hash
from ..util import logging as slog
from ..util.clock import ClockMode, VirtualClock
from ..xdr import scp as SX
from ..xdr import types as XT

log = slog.get("Herder")


class SimNode:
    """One in-process validator: ledger manager + herder + overlay.
    Reference analog: a full Application instance inside Simulation."""

    def __init__(self, sim: "Simulation", secret: SecretKey, qset,
                 is_validator: bool = True,
                 upgrades: Optional[Upgrades] = None,
                 ledger_manager: Optional[LedgerManager] = None):
        self.sim = sim
        self.secret = secret
        self.node_id = secret.public_key.ed25519
        if ledger_manager is not None:   # restart path: resumed from disk
            self.lm = ledger_manager
        else:
            self.lm = LedgerManager(sim.network_id)
            self.lm.start_new_ledger()
        self.herder = Herder(sim.clock, self.lm, secret, qset,
                             is_validator=is_validator, upgrades=upgrades)
        # the OverlayManager rewires herder.broadcast / tx_flood / fetch_*
        # onto the real flood/fetch machinery
        self.overlay = OverlayManager(sim.clock, self.herder, sim.network_id,
                                      secret, batching=sim.batching)
        self.partition = 0   # connection-group tag (see partition_nodes)
        self.closed: Dict[int, bytes] = {}  # seq -> ledger hash
        # per-category status lines, same manager a full Application runs
        # (main/status) — evaluate_health reuses it unchanged
        self.status = StatusManager()
        # in-sim history archive (attach_history): real publish path +
        # real archive catchup when the gap exceeds the fleet's slot memory
        self.archive = None
        self.history = None
        self.catchup_parallel = 1
        self._catching_up = False
        self.herder.ledger_closed_hook = self._on_ledger_closed
        self.herder.out_of_sync_handler = self._on_out_of_sync
        self.herder.sync_gap_hook = self.maybe_archive_catchup

    def attach_history(self, archive, publish: bool = True,
                       parallel: int = 1) -> None:
        """Attach a history archive (history.archive.FileHistoryArchive —
        typically one directory SHARED by the fleet, like a production
        network's archive mirrors): with `publish` this node writes real
        checkpoints as ledgers close (HistoryManager), and either way a
        stall past ``MAX_SLOTS_TO_REMEMBER`` recovers through real
        archive catchup (``parallel`` > 1 routes it through
        ``catchup --parallel``-style range workers)."""
        from ..history.manager import HistoryManager
        self.archive = archive
        self.catchup_parallel = parallel
        if publish:
            self.history = HistoryManager(
                self.lm, self.sim.network_passphrase.decode(), [archive])

    def _on_out_of_sync(self) -> None:
        # pull recent SCP state from peers (reference: getMoreSCPState);
        # the sync_gap_hook hands off to archive catchup when the
        # buffered-externalize queue proves the gap exceeds the peers'
        # slot memory
        self.overlay.request_scp_state()

    def _on_ledger_closed(self, arts) -> None:
        self.closed[arts.header_entry.header.ledgerSeq] = arts.header_entry.hash
        # floodgate GC, exactly like a full Application's close hook: a
        # bounded record map ALSO means a replayed stale envelope reads
        # as new and reaches the herder's slot-memory discard (the
        # byzantine stale-replay scenarios assert that path)
        self.overlay.clear_below(
            max(0, self.lm.last_closed_ledger_seq - 100))
        if self.history is not None:
            self.history.ledger_closed(arts)
        if self.status.get_status("history-catchup") is not None \
                and self.herder.state == HerderState.TRACKING:
            # archive recovery complete: the node is closing live ledgers
            # again — /health flips from "catching-up" back to "ok"
            self.status.clear_status("history-catchup")

    def enable_admission(self, **knobs) -> None:
        """Batched admission in front of this node's tx queue, verifying
        where the simulation's accel settings say, its back-pressure
        valve wired into overlay flow control as a full Application
        wires it (herder.enable_admission's knobs: batch_size,
        max_backlog, ...)."""
        self.herder.enable_admission(accel=self.sim.accel,
                                     accel_device=self.sim.accel_device,
                                     **knobs)
        self.herder.admission.on_backpressure_release = \
            self.overlay.release_flood_grants

    # -- archive catchup (out-of-sync -> archive -> re-tracking) -----------
    def maybe_archive_catchup(self) -> None:
        """The handoff the reference calls CatchupManager::processLedger →
        startCatchup: when the next slot this node needs is older than
        any peer remembers (gap > MAX_SLOTS_TO_REMEMBER), SCP-state
        replays cannot help — resync from the archive, then bridge the
        remaining slots through the normal buffered-externalize path."""
        from ..herder.herder import MAX_SLOTS_TO_REMEMBER
        if self.archive is None or self._catching_up:
            return
        buffered = self.herder._buffered
        net_tip = max(buffered, default=self.lcl)
        if net_tip - self.lcl <= MAX_SLOTS_TO_REMEMBER:
            return   # peers' slot memory still covers the gap
        try:
            has = self.archive.get_state()
        except (ValueError, OSError):
            return   # unreadable HAS: keep trying the SCP-state path
        if has is None or has.current_ledger <= self.lcl:
            return   # nothing newer published yet
        self.run_archive_catchup()

    def run_archive_catchup(self) -> None:
        """Run REAL archive catchup (hash-verified header chain, bucket
        apply, tx replay — `catchup --parallel` range workers when
        `catchup_parallel` > 1) and adopt the resulting ledger state into
        the live node."""
        from ..catchup.catchup import CatchupError, CatchupManager
        from ..history.archive import checkpoint_frequency
        from ..util import eventlog
        self._catching_up = True
        self.herder.recovery_stats["archive_catchups"] += 1
        self.status.set_status(
            "history-catchup",
            f"catching up from archive (lcl {self.lcl} is beyond the "
            f"fleet's slot memory)")
        eventlog.record("History", "INFO", "sim archive catchup start",
                        node=self.node_id.hex()[:8], lcl=self.lcl,
                        parallel=self.catchup_parallel)
        try:
            if self.catchup_parallel > 1:
                from ..catchup.parallel import ParallelCatchup
                pc = ParallelCatchup(
                    self.archive.root,
                    self.sim.network_passphrase.decode(),
                    workers=self.catchup_parallel,
                    accel=self.sim.accel,
                    accel_device=self.sim.accel_device)
                try:
                    pc.run()
                    new_lm = pc.load_manager()
                    # sim nodes are in-memory: detach the loaded
                    # manager's persistence (it points into the
                    # throwaway range workdir) BEFORE that dir is
                    # reclaimed below
                    new_lm.db = None
                    new_lm.bucket_dir = None
                finally:
                    pc.cleanup()
            else:
                cm = CatchupManager(self.sim.network_id,
                                    self.sim.network_passphrase.decode(),
                                    accel=self.sim.accel,
                                    accel_device=self.sim.accel_device)
                new_lm = cm.catchup_recent(self.archive,
                                           count=checkpoint_frequency())
        except CatchupError as e:
            log.warning("sim archive catchup failed at lcl=%d: %s",
                        self.lcl, e)
            eventlog.record("History", "ERROR", "sim archive catchup FAILED",
                            node=self.node_id.hex()[:8], detail=str(e))
            # the node is NOT catching up anymore — it is stuck.  Clear
            # the category so /health reports plain "degraded" (needs
            # attention), not the transient "catching-up" ("will be
            # back"); the failure detail lives in the flight recorder.
            # A later gap signal retries and re-sets the status.
            self.status.clear_status("history-catchup")
            self._catching_up = False
            return
        self._adopt_ledger_manager(new_lm)
        try:
            # bridge archive tip -> live consensus: apply whatever the
            # buffered-externalize queue already holds, then re-pull SCP
            # state for the remainder (guard still held: the drain's own
            # dead-end signal must not re-enter catchup against the same
            # archive tip)
            self.herder._drain_buffered()
            self.overlay.request_scp_state()
        finally:
            self._catching_up = False

    def _adopt_ledger_manager(self, new_lm: LedgerManager) -> None:
        from ..util import eventlog
        old = self.lcl
        self.lm = new_lm
        self.herder.lm = new_lm
        self.herder.tx_queue.lm = new_lm
        if self.history is not None:
            self.history.ledger_mgr = new_lm
            # artifacts for the skipped range were never closed here; the
            # straddling checkpoint window must not be published with holes
            self.history.resume_from(new_lm.last_closed_ledger_seq + 1)
        eventlog.record("History", "INFO", "sim archive state adopted",
                        node=self.node_id.hex()[:8], from_lcl=old,
                        to_lcl=new_lm.last_closed_ledger_seq)
        log.info("sim node %s adopted archive state: lcl %d -> %d",
                 self.node_id.hex()[:8], old,
                 new_lm.last_closed_ledger_seq)

    # -- convenience -------------------------------------------------------
    @property
    def lcl(self) -> int:
        return self.lm.last_closed_ledger_seq

    @property
    def lcl_hash(self) -> bytes:
        return self.lm.lcl_hash

    @property
    def clock(self) -> VirtualClock:
        return self.sim.clock

    def submit(self, frame) -> object:
        return self.herder.recv_transaction(frame)

    def evaluate_health(self) -> dict:
        """The same ``/health`` document a full Application serves
        (main/status.evaluate_health over this node's ledger age, herder
        state, tx-queue depth and peer count) — the chaos runner's
        degraded/recovered assertions reuse production health logic
        instead of re-deriving it."""
        from ..main.status import evaluate_health
        return evaluate_health(self)

    def is_healthy(self) -> bool:
        return self.evaluate_health()["status"] == "ok"


class Simulation:
    OVER_LOOPBACK = "loopback"

    def __init__(self, network_passphrase: bytes = b"sim network",
                 mode: str = OVER_LOOPBACK,
                 seed: Optional[int] = None,
                 batching: bool = True, accel: bool = False,
                 accel_device=None):
        # signature offload of every node's archive catchup and admission
        self.accel = accel
        self.accel_device = accel_device
        # batched authenticated transport for every node this sim creates
        # (chaos campaigns and benches flip it to compare modes; links
        # negotiate per-pair so mixed fleets also work)
        self.batching = batching
        self.network_passphrase = network_passphrase
        self.network_id = sha256(network_passphrase)
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        self.nodes: List[SimNode] = []
        self.by_id: Dict[bytes, SimNode] = {}
        # live loopback connections: frozenset({id_a, id_b}) -> (pa, pb)
        self._connections: Dict[frozenset, Tuple] = {}
        # fault-injection determinism: when a seed is given, every
        # loopback pair gets its own random stream derived from
        # (seed, the two node ids) — stable under dial order and under
        # redials, so one logged integer replays a whole campaign's
        # damage/drop/reorder decisions.  `self.rng` is the scheduler-level
        # stream (fault timing jitter etc.).
        self.seed = seed
        self.rng = random.Random(seed)

    def _pair_rng(self, id_a: bytes, id_b: bytes) -> Optional[random.Random]:
        if self.seed is None:
            return None
        lo, hi = sorted((id_a, id_b))
        material = sha256(b"link-fault-rng|" +
                          self.seed.to_bytes(8, "big", signed=True) +
                          lo + hi)
        return random.Random(int.from_bytes(material, "big"))

    # -- topology ----------------------------------------------------------
    def add_node(self, secret: SecretKey, qset,
                 is_validator: bool = True,
                 upgrades: Optional[Upgrades] = None,
                 ledger_manager: Optional[LedgerManager] = None) -> SimNode:
        node = SimNode(self, secret, qset, is_validator, upgrades,
                       ledger_manager=ledger_manager)
        self.nodes.append(node)
        self.by_id[node.node_id] = node
        return node

    def connect(self, a: SimNode, b: SimNode) -> None:
        """Dial a loopback connection a->b (reference:
        Simulation::addPendingConnection + LoopbackPeerConnection).  A pair
        whose peers dropped THEMSELVES (overlay error paths, bans) counts
        as absent — otherwise heal_partitions would silently no-op on it
        and the mesh would stay severed while the sim believes it healed."""
        from ..overlay.peer import Peer
        if a is b:
            return
        key = frozenset((a.node_id, b.node_id))
        pair = self._connections.get(key)
        if pair is not None:
            if pair[0].state != Peer.CLOSING and \
                    pair[1].state != Peer.CLOSING:
                return  # still live
            del self._connections[key]
        self._connections[key] = make_loopback_pair(
            a.overlay, b.overlay,
            fault_rng=self._pair_rng(a.node_id, b.node_id))

    def disconnect(self, a: SimNode, b: SimNode) -> None:
        """Sever a link.  BOTH ends are dropped explicitly: drop() on a
        peer that is already CLOSING (it dropped itself earlier — ban,
        overlay error) is a no-op that never reaches its partner, so
        dropping only pair[0] could leak a half-open connection that a
        later flapping redial would then refuse to replace."""
        from ..overlay.peer import Peer
        key = frozenset((a.node_id, b.node_id))
        pair = self._connections.pop(key, None)
        if pair is not None:
            pair[0].drop("sim disconnect")
            pair[1].drop("sim disconnect")
            assert pair[0].state == Peer.CLOSING \
                and pair[1].state == Peer.CLOSING, \
                "severed loopback pair must close both ends"

    def is_connected(self, a: SimNode, b: SimNode) -> bool:
        from ..overlay.peer import Peer
        pair = self._connections.get(frozenset((a.node_id, b.node_id)))
        return pair is not None and pair[0].state != Peer.CLOSING \
            and pair[1].state != Peer.CLOSING

    def start_all_nodes(self, mesh: bool = True) -> None:
        # default mesh: every node pair connected (the bus the herder sims
        # assume); explicit connect() calls before start override nothing —
        # connect() is idempotent per pair.  mesh=False keeps whatever
        # sparse graph the caller dialed (large chaos topologies would be
        # O(n^2) links otherwise).
        if mesh:
            for i, a in enumerate(self.nodes):
                for b in self.nodes[i + 1:]:
                    self.connect(a, b)
        # let the auth handshakes complete before consensus starts
        self.clock.crank_for(0.1)
        for n in self.nodes:
            if n.herder.is_validator:
                n.herder.bootstrap()
            else:
                n.herder.start()

    # -- partitions (fault injection) --------------------------------------
    def partition_nodes(self, groups: List[List[SimNode]]) -> None:
        """Sever every loopback connection crossing group boundaries
        (reference: Simulation::partitionNodes — connection-level cuts)."""
        for i, grp in enumerate(groups):
            for n in grp:
                n.partition = i
        for key in list(self._connections):
            ids = list(key)
            a, b = self.by_id[ids[0]], self.by_id[ids[1]]
            if a.partition != b.partition:
                self.disconnect(a, b)

    def heal_partitions(self) -> None:
        """Redial the full mesh (reference: healing a Simulation
        partition reconnects the pending connections)."""
        for n in self.nodes:
            n.partition = 0
        for i, a in enumerate(self.nodes):
            for b in self.nodes[i + 1:]:
                self.connect(a, b)

    # -- cranking ----------------------------------------------------------
    def crank_until(self, pred: Callable[[], bool],
                    timeout: float = 120.0) -> bool:
        return self.clock.crank_until(pred, timeout)

    def crank_for_at_least(self, duration: float) -> None:
        self.clock.crank_for(duration)

    def crank_until_ledger(self, seq: int, timeout: float = 120.0) -> bool:
        """Crank until every validator has closed ledger `seq`."""
        vs = [n for n in self.nodes if n.herder.is_validator]
        return self.crank_until(lambda: all(n.lcl >= seq for n in vs),
                                timeout)

    def hashes_agree(self, seq: Optional[int] = None) -> bool:
        """All validators that closed ledger `seq` derived the same hash
        (default: highest ledger every validator has closed)."""
        vs = [n for n in self.nodes if n.herder.is_validator]
        if not vs:
            return True
        if seq is None:
            seq = min(n.lcl for n in vs)
        hashes = {n.closed.get(seq) for n in vs if seq in n.closed}
        return len(hashes) <= 1


def qset_of(node_ids: List[bytes], threshold: int):
    return SX.SCPQuorumSet(threshold=threshold,
                           validators=[XT.node_id(n) for n in node_ids],
                           innerSets=[])


def make_core_topology(n: int, threshold: Optional[int] = None,
                       passphrase: bytes = b"sim network",
                       seed: Optional[int] = None) -> Simulation:
    """Fully-connected n-validator network with a shared flat qset.
    Reference: Topologies::core."""
    sim = Simulation(passphrase, seed=seed)
    secrets = [SecretKey(bytes([i + 1]) * 32) for i in range(n)]
    ids = [s.public_key.ed25519 for s in secrets]
    q = qset_of(ids, threshold if threshold is not None else (2 * n + 2) // 3)
    for s in secrets:
        sim.add_node(s, q)
    return sim


def make_cycle_topology(n: int,
                        passphrase: bytes = b"sim cycle",
                        seed: Optional[int] = None) -> Simulation:
    """Ring: each validator trusts itself and both ring neighbours (2-of-3
    slices).  Reference: Topologies::cycle — connectivity-limited liveness
    testing; intersection holds because adjacent slices chain around the
    ring."""
    sim = Simulation(passphrase, seed=seed)
    secrets = [SecretKey(bytes([i + 1]) * 32) for i in range(n)]
    ids = [s.public_key.ed25519 for s in secrets]
    for i, s in enumerate(secrets):
        neigh = [ids[i], ids[(i - 1) % n], ids[(i + 1) % n]]
        sim.add_node(s, qset_of(neigh, 2))
    return sim


def make_hierarchical_topology(n_orgs: int, nodes_per_org: int = 3,
                               passphrase: bytes = b"sim tiers",
                               seed: Optional[int] = None
                               ) -> Simulation:
    """Tiered: org-inner 2-of-3 qsets nested under a 2/3-of-orgs outer
    threshold — the tier-1 shape (reference: Topologies::hierarchicalQuorum;
    same org structure the quorum-intersection bench uses)."""
    from ..crypto.sha import sha256
    sim = Simulation(passphrase, seed=seed)
    secrets = [[SecretKey(sha256(b"hier-node-%d-%d" % (o, g)))
                for g in range(nodes_per_org)] for o in range(n_orgs)]
    inner = [qset_of([s.public_key.ed25519 for s in org],
                     (2 * nodes_per_org + 2) // 3) for org in secrets]
    outer_threshold = (2 * n_orgs + 2) // 3
    outer = SX.SCPQuorumSet(threshold=outer_threshold, validators=[],
                            innerSets=inner)
    for org in secrets:
        for s in org:
            sim.add_node(s, outer)
    return sim


def make_intersection_violation_topology(group_size: int = 2,
                                         passphrase: bytes = b"sim split",
                                         seed: Optional[int] = None
                                         ) -> Simulation:
    """GENERATED INTERSECTION-VIOLATION AXIS: two disjoint near-quorums
    bridged by ONE shared validator z (the last node).  Group A nodes
    trust {A, z} unanimously, group B nodes trust {B, z} unanimously, and
    z itself follows side A — so every A-side quorum is {A, z} and every
    B-side quorum is {B, z}: they intersect ONLY at z.  The survey's
    safety precondition (quorum intersection at honest nodes —
    `QuorumIntersectionChecker`) fails by exactly one node: with z
    honest the network behaves (z's value reaches both sides), with z
    equivocating the two sides can commit different values for the same
    slot, and the per-crank safety assertion MUST flag the fork.
    Unanimous thresholds make every member v-blocking for its group
    (one equivocator drives each side's federated accepts), and z
    announces a SELF-SINGLETON quorum set — required for either side's
    transitive quorum to close over z, and the honest-looking shape a
    real saboteur would pick."""
    from ..crypto.sha import sha256
    from ..scp.quorum import singleton_qset
    sim = Simulation(passphrase, seed=seed)
    a = [SecretKey(sha256(b"split-a-%d" % i)) for i in range(group_size)]
    b = [SecretKey(sha256(b"split-b-%d" % i)) for i in range(group_size)]
    z = SecretKey(sha256(b"split-bridge"))
    a_ids = [s.public_key.ed25519 for s in a]
    b_ids = [s.public_key.ed25519 for s in b]
    z_id = z.public_key.ed25519
    qset_a = qset_of(a_ids + [z_id], group_size + 1)   # unanimous
    qset_b = qset_of(b_ids + [z_id], group_size + 1)
    for s in a:
        sim.add_node(s, qset_a)
    for s in b:
        sim.add_node(s, qset_b)
    sim.add_node(z, singleton_qset(z_id))
    return sim


def split_brain_links(group_size: int = 2):
    """Overlay graph for the intersection-violation topology: each group
    meshed internally, the bridge z connected to everyone, NO direct
    A-B links (each side hears the other only through z's relay)."""
    a = list(range(group_size))
    b = list(range(group_size, 2 * group_size))
    z = 2 * group_size
    links = {frozenset((i, j)) for i in a for j in a if i < j}
    links |= {frozenset((i, j)) for i in b for j in b if i < j}
    links |= {frozenset((i, z)) for i in a + b}
    return links


def make_asymmetric_topology(n_core_orgs: int, nodes_per_org: int = 3,
                             n_leaf: int = 10,
                             passphrase: bytes = b"sim asym",
                             seed: Optional[int] = None) -> Simulation:
    """Asymmetric tiers: a hierarchical tier-1 core plus ``n_leaf``
    second-tier validators whose quorum slices point AT the core's org
    structure but who appear in nobody else's slices — they vote and
    close ledgers yet cannot block the core (the shape of real public
    networks, where most validators trust the tier-1 orgs one-way).
    Reference shape: Topologies::hierarchicalQuorumSimplified's
    middle-tier variants."""
    from ..crypto.sha import sha256
    sim = Simulation(passphrase, seed=seed)
    secrets = [[SecretKey(sha256(b"asym-core-%d-%d" % (o, g)))
                for g in range(nodes_per_org)] for o in range(n_core_orgs)]
    inner = [qset_of([s.public_key.ed25519 for s in org],
                     (2 * nodes_per_org + 2) // 3) for org in secrets]
    outer = SX.SCPQuorumSet(threshold=(2 * n_core_orgs + 2) // 3,
                            validators=[], innerSets=inner)
    for org in secrets:
        for s in org:
            sim.add_node(s, outer)
    for i in range(n_leaf):
        sim.add_node(SecretKey(sha256(b"asym-leaf-%d" % i)), outer)
    return sim
