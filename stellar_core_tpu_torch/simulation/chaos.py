"""Chaos campaign runner: 50-300-node consensus soaks with scripted
faults, continuous safety/liveness assertions and measured recovery.

Reference shape: src/simulation/Simulation + Topologies give the
deterministic multi-node substrate (SURVEY.md §4); this module composes
every fault ingredient the repo already has — partitions with healing
(`Simulation.partition`-style link cuts), LoopbackPeer damage/drop/
reorder knobs, validator stall+rejoin (forcing buffered-externalize /
out-of-sync SCP-state recovery), node bans, and corrupted floods — into
**scripted fault schedules**: typed events fired at virtual times on the
shared VirtualClock.

While the schedule plays, the runner continuously asserts the three
invariants that define a correct validator fleet:

- **safety** — no two nodes ever externalize different hashes for the
  same slot (checked every crank over each `SimNode.closed` map against
  a campaign-global canonical slot->hash table);
- **liveness** — ledgers keep closing: a network-wide progress stall
  longer than `liveness_grace_targets` close targets, outside a
  scenario-declared `allow_stall` window, is a violation (a
  quorum-splitting partition is *detected*, not survived);
- **bounded recovery** — after a heal marked `measure_recovery`, every
  validator must converge to one LCL hash within
  `recovery_close_targets` close targets; the measured virtual recovery
  time is reported.

A failing scenario emits a replayable post-mortem: the process flight
recorder is dumped via ``util/eventlog.write_crash_bundle`` (with a
``chaos`` bundle source carrying scenario name, RNG seed, fault schedule
and violations) plus a per-node record file — node ids, LCLs, herder
state + recovery stats, health verdicts, recent closes — and the seed
needed to re-run the identical campaign (`Simulation(seed=...)` threads
it into every loopback pair's fault RNG).

Topology note: 50+-node campaigns run on *sparse* overlay graphs (org
meshes + org rings, leaf uplinks) — consensus traffic traverses the real
flood/fetch relay machinery rather than an all-pairs bus, which is both
realistic and what keeps 300-node soaks tractable in-process.

The copy of stellar_core_tpu/simulation/chaos.py.  Its nodes run on
``Simulation``, which verifies on the CPU unless a scenario gives it accel
settings; the catalogue gives none.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .. import xdr as X
from ..util import eventlog
from ..util import logging as slog
from ..util.clock import VirtualTimer
from ..xdr import scp as SX
from .simulation import (SimNode, Simulation,
                         make_asymmetric_topology, make_core_topology,
                         make_cycle_topology, make_hierarchical_topology,
                         make_intersection_violation_topology,
                         split_brain_links)

log = slog.get("Sim")

# how many recent closes each per-node flight record keeps in artifacts
NODE_RECORD_TAIL = 8


# ---------------------------------------------------------------------------
# typed fault events (all times are virtual seconds after campaign start)
# ---------------------------------------------------------------------------

class FaultEvent:
    """Base: one scripted fault at virtual time `at`."""

    at: float

    def describe(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(vars(self).items())
                       if k != "at")
        return f"{type(self).__name__}(at={self.at:g}, {kv})"


class Partition(FaultEvent):
    """Named link cut: sever every base link crossing a group boundary.
    `groups` are node-index lists; nodes in none of them form an implicit
    remainder group.  Overlapping cuts COMPOSE — a link is down while ANY
    active cut severs it."""

    def __init__(self, at: float, groups: Sequence[Sequence[int]],
                 name: str = "cut"):
        self.at = at
        self.groups = [list(g) for g in groups]
        self.name = name


class CutLink(FaultEvent):
    """Named cut of ONE link — degrades connectivity without splitting
    the overlay graph (flooding reroutes around it).  This is the right
    fault for topologies whose quorum slices lack global intersection
    (a cycle's 2-of-3 neighbour slices): a group Partition there can
    create two disjoint quorums and a *legitimate* fork, which the
    safety checker will flag."""

    def __init__(self, at: float, a: int, b: int,
                 name: Optional[str] = None):
        self.at = at
        self.a = a
        self.b = b
        self.name = name if name is not None else f"link-{a}-{b}"


class Heal(FaultEvent):
    """Remove the named cut (None = all cuts).  `measure_recovery` arms
    the bounded-recovery assertion: all validators must converge to one
    LCL hash within the scenario's recovery budget."""

    def __init__(self, at: float, name: Optional[str] = None,
                 measure_recovery: bool = False):
        self.at = at
        self.name = name
        self.measure_recovery = measure_recovery


class Flap(FaultEvent):
    """`count` partition/heal alternations of `period` seconds each —
    expanded at schedule build time into Partition/Heal pairs."""

    def __init__(self, at: float, groups: Sequence[Sequence[int]],
                 period: float, count: int, name: str = "flap"):
        self.at = at
        self.groups = [list(g) for g in groups]
        self.period = period
        self.count = count
        self.name = name

    def expand(self) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        t = self.at
        for i in range(self.count):
            out.append(Partition(t, self.groups, name=f"{self.name}-{i}"))
            out.append(Heal(t + self.period, name=f"{self.name}-{i}"))
            t += 2 * self.period
        return out


class LinkFault(FaultEvent):
    """Set damage/drop/reorder probabilities on loopback links: both ends
    of every live link of node `node` (or of ALL nodes when None).
    Ramps are several LinkFaults at increasing `at`.  A damaged frame
    fails the receiver's MAC check and fail-stops the connection — the
    runner's periodic reconcile redials it, modelling an operator
    restart."""

    def __init__(self, at: float, node: Optional[int] = None,
                 damage: float = 0.0, drop: float = 0.0,
                 reorder: float = 0.0):
        self.at = at
        self.node = node
        self.damage = damage
        self.drop = drop
        self.reorder = reorder


class StallNode(FaultEvent):
    """Isolate one validator (its own named cut) — long enough past the
    peers' slot memory this forces buffered-externalize catchup and
    out-of-sync SCP-state recovery at rejoin."""

    def __init__(self, at: float, node: int):
        self.at = at
        self.node = node


class RejoinNode(FaultEvent):
    def __init__(self, at: float, node: int,
                 measure_recovery: bool = False):
        self.at = at
        self.node = node
        self.measure_recovery = measure_recovery


class Ban(FaultEvent):
    """`node` bans `target`'s identity: the live link drops and the
    runner stops redialing it until Unban."""

    def __init__(self, at: float, node: int, target: int):
        self.at = at
        self.node = node
        self.target = target


class Unban(FaultEvent):
    def __init__(self, at: float, node: int, target: int):
        self.at = at
        self.node = node
        self.target = target


class CorruptFlood(FaultEvent):
    """`node` emits `frames` corrupted frames to each authenticated peer
    (one-shot damage on the outbound path).  Receivers must fail-stop the
    connection (bad MAC), never apply the payload; the reconcile pass
    redials afterwards."""

    def __init__(self, at: float, node: int, frames: int = 2):
        self.at = at
        self.node = node
        self.frames = frames


class ByzantineNode(FaultEvent):
    """Turn SIGNING validator `node` Byzantine at virtual time `at`:
    from then on its outbound SCP traffic is adversarial — properly
    signed with its real validator key, so receivers cannot tell it from
    an honest (if confusing) peer.  Modes (composable — several events on
    one node accumulate):

    - ``equivocate`` — every outgoing statement (nomination AND ballot)
      is re-signed per peer *group* with a mutated ``StellarValue``: a
      different value to different peers for the same slot/ballot, the
      textbook SCP equivocation fault.
    - ``conflicting-nominate`` — only NOMINATE statements equivocate
      (conflicting nomination votes; the ballot protocol stays truthful).
    - ``stale-replay`` — alongside live traffic the node re-sends its own
      recorded envelopes from slots older than the fleet's slot memory;
      receivers must discard them via the ``MAX_SLOTS_TO_REMEMBER``
      window check (observable: ``herder.scp.envelope-discarded``).

    `groups`: node-index lists assigning peers to equivocation variants
    (group k receives the value mutated by +k seconds of closeTime; nodes
    in no list form implicit group 0 = the node's true statements).
    Default None splits authenticated peers deterministically by node-id
    parity.  In a healthy-intersection topology every quorum crosses the
    groups, so honest nodes must never externalize divergent hashes; in
    an intersection-violation topology (two disjoint near-quorums bridged
    only by this node) the equivocation FORKS the network and the
    per-crank safety assertion must flag it."""

    def __init__(self, at: float, node: int, mode: str = "equivocate",
                 groups: Optional[Sequence[Sequence[int]]] = None):
        if mode not in ("equivocate", "conflicting-nominate",
                        "stale-replay"):
            raise ValueError(f"unknown byzantine mode {mode!r}")
        self.at = at
        self.node = node
        self.mode = mode
        self.groups = [list(g) for g in groups] if groups is not None \
            else None


# ---------------------------------------------------------------------------
# sparse overlay graphs (node-index link sets)
# ---------------------------------------------------------------------------

def mesh_links(n: int) -> Set[frozenset]:
    return {frozenset((i, j)) for i in range(n) for j in range(i + 1, n)}


def ring_links(n: int, hops: int = 2) -> Set[frozenset]:
    """Ring plus `hops`-neighbour chords (so one severed node cannot cut
    the ring)."""
    out: Set[frozenset] = set()
    for i in range(n):
        for h in range(1, hops + 1):
            out.add(frozenset((i, (i + h) % n)))
    return out


def hierarchical_links(n_orgs: int, nodes_per_org: int = 3
                       ) -> Set[frozenset]:
    """Org-internal meshes + two independent org rings (org i node k <->
    org i+1 node k for k in {0,1}) — severing one inter-org edge never
    disconnects the org graph."""
    out: Set[frozenset] = set()
    for o in range(n_orgs):
        base = o * nodes_per_org
        for i in range(nodes_per_org):
            for j in range(i + 1, nodes_per_org):
                out.add(frozenset((base + i, base + j)))
        nxt = ((o + 1) % n_orgs) * nodes_per_org
        for k in range(min(2, nodes_per_org)):
            out.add(frozenset((base + k, nxt + k)))
    return out


def asymmetric_links(n_core_orgs: int, nodes_per_org: int,
                     n_leaf: int) -> Set[frozenset]:
    """Hierarchical core graph + each leaf uplinked to two core nodes
    (deterministic spread)."""
    out = hierarchical_links(n_core_orgs, nodes_per_org)
    n_core = n_core_orgs * nodes_per_org
    for i in range(n_leaf):
        leaf = n_core + i
        out.add(frozenset((leaf, (2 * i) % n_core)))
        out.add(frozenset((leaf, (2 * i + 1 + n_core // 2) % n_core)))
    return out


def org_indices(org: int, nodes_per_org: int = 3) -> List[int]:
    return list(range(org * nodes_per_org, (org + 1) * nodes_per_org))


# ---------------------------------------------------------------------------
# scenario + result
# ---------------------------------------------------------------------------

class ChaosScenario:
    """One scripted campaign: a topology builder, a fault schedule, and
    assertion budgets.  `build(seed)` returns `(sim, links)` where
    `links` is the base overlay graph as node-index pairs."""

    def __init__(self, name: str,
                 build: Callable[[int], Tuple[Simulation, Set[frozenset]]],
                 schedule: Sequence[FaultEvent],
                 duration_s: float = 60.0,
                 seed: int = 0,
                 recovery_close_targets: float = 12.0,
                 liveness_grace_targets: float = 8.0,
                 allow_stall: Sequence[Tuple[float, float]] = (),
                 expect_failure: Optional[str] = None,
                 checkpoint_frequency: Optional[int] = None,
                 batching: bool = True,
                 description: str = ""):
        self.name = name
        self.build = build
        self.schedule = list(schedule)
        self.duration_s = duration_s
        self.seed = seed
        self.recovery_close_targets = recovery_close_targets
        self.liveness_grace_targets = liveness_grace_targets
        self.allow_stall = [tuple(w) for w in allow_stall]
        # set on intentionally-broken scenarios: the violation kind the
        # runner MUST detect ("liveness", "safety", "recovery")
        self.expect_failure = expect_failure
        # archive-recovery scenarios accelerate the checkpoint cadence
        # (the cadence is archive FORMAT: runner sets it process-wide for
        # the campaign and restores it after)
        self.checkpoint_frequency = checkpoint_frequency
        # batched authenticated transport for the whole fleet (the runner
        # applies it to every node before any link is dialed); False
        # replays a campaign over classic per-message frames — the
        # replay-identity and bench comparisons run both modes
        self.batching = batching
        self.description = description
        # optional teardown the runner invokes after the campaign —
        # scenarios that provision on-disk state (a shared history
        # archive) reclaim it here
        self.cleanup: Optional[Callable[[], None]] = None


class Violation:
    def __init__(self, kind: str, at_vt: float, detail: str):
        self.kind = kind
        self.at_vt = at_vt
        self.detail = detail

    def to_dict(self) -> dict:
        return {"kind": self.kind, "at_vt": round(self.at_vt, 3),
                "detail": self.detail}

    def __repr__(self) -> str:
        return f"Violation({self.kind!r}, at={self.at_vt:g}, {self.detail!r})"


class ChaosResult:
    def __init__(self, scenario: ChaosScenario):
        self.scenario = scenario.name
        self.seed = scenario.seed
        self.violations: List[Violation] = []
        self.recoveries: List[dict] = []   # {heal_vt, recovery_s, slot}
        self.ledgers_closed = 0
        self.nodes = 0
        self.virtual_s = 0.0
        self.event_trace: List[Tuple[float, str]] = []
        self.slot_hashes: Dict[int, bytes] = {}    # canonical slot -> hash
        self.node_records: List[dict] = []
        self.artifact_path: Optional[str] = None
        self.crash_bundle_path: Optional[str] = None

    @property
    def passed(self) -> bool:
        return not self.violations

    def to_report(self) -> dict:
        out = {
            "scenario": self.scenario,
            "seed": self.seed,
            "passed": self.passed,
            "nodes": self.nodes,
            "ledgers_closed": self.ledgers_closed,
            "virtual_s": round(self.virtual_s, 1),
            "violations": [v.to_dict() for v in self.violations],
        }
        if self.recoveries:
            out["recovery_s"] = [round(r["recovery_s"], 2)
                                 for r in self.recoveries]
        if self.artifact_path:
            out["artifact"] = self.artifact_path
        return out


# ---------------------------------------------------------------------------
# byzantine emission engine
# ---------------------------------------------------------------------------

class _ByzantineEngine:
    """Installed over one SimNode's SCP emission path (herder.broadcast)
    by a ByzantineNode event.  All adversarial statements are REAL SCP
    statements re-signed with the node's actual validator key; the only
    lie is WHICH statement each peer receives.

    Equivocation mutates the StellarValue inside every pledge uniformly
    (+delta seconds of closeTime per peer group, delta 0 = the true
    statement).  A uniform per-group delta is order-preserving on value
    bytes (the tx-set hash is shared and closeTime is big-endian), so the
    mutated statement still passes the receiver's isStatementSane checks
    — the attack is semantic, not syntactic, which is exactly what makes
    it dangerous and what the honest-fleet scenarios must survive."""

    # keep this many of our own emitted envelopes for stale replays
    REPLAY_MEMORY = 256
    # a replayed envelope must be at least this many slots behind the
    # live one so receivers are FORCED through the slot-memory discard
    STALE_GAP = 13   # MAX_SLOTS_TO_REMEMBER + 1
    REPLAYS_PER_EMIT = 2

    def __init__(self, runner: "ChaosRunner", node_index: int):
        self.runner = runner
        self.node_index = node_index
        self.node = runner.sim.nodes[node_index]
        self.equivocate = False
        self.conflicting_nominate = False
        self.stale_replay = False
        # node_id -> variant group (from ByzantineNode.groups); empty =
        # deterministic node-id parity split
        self.group_of_id: Dict[bytes, int] = {}
        self._emitted = deque(maxlen=self.REPLAY_MEMORY)
        self._orig_broadcast = self.node.herder.broadcast
        self.node.herder.broadcast = self._on_emit
        self.stats = {"equivocal_sent": 0, "stale_replayed": 0}

    def enable(self, mode: str,
               groups: Optional[Sequence[Sequence[int]]]) -> None:
        if mode == "equivocate":
            self.equivocate = True
        elif mode == "conflicting-nominate":
            self.conflicting_nominate = True
        else:
            self.stale_replay = True
        if groups is not None:
            # listed group k receives variant k+1 (delta k+1 seconds);
            # unlisted nodes form implicit group 0 = the true statements
            sim = self.runner.sim
            for gi, grp in enumerate(groups):
                for idx in grp:
                    self.group_of_id[sim.nodes[idx].node_id] = gi + 1

    # -- variant crafting --------------------------------------------------
    def _group_of(self, peer_id: bytes) -> int:
        got = self.group_of_id.get(peer_id)
        if got is not None:
            return got
        if self.group_of_id:
            return 0          # nodes outside every declared group
        return peer_id[0] & 1  # deterministic parity split

    def _mutate_value(self, vbytes: bytes, delta: int) -> bytes:
        try:
            sv = X.StellarValue.from_xdr(vbytes)
        except X.XdrError:
            return vbytes
        return X.StellarValue(txSetHash=sv.txSetHash,
                              closeTime=sv.closeTime + delta,
                              upgrades=list(sv.upgrades)).to_xdr()

    def _mutate_ballot(self, xb, delta: int):
        return SX.SCPBallot(counter=xb.counter,
                            value=self._mutate_value(xb.value, delta))

    def _variant(self, env, delta: int, force: bool = False):
        """The envelope peer group `delta` receives: the statement with
        every embedded value shifted, re-signed with our real key.
        `force` mutates ballot statements even when only
        conflicting-nominate mode is armed (stale replays must be bytes
        nobody's floodgate remembers, or dedup absorbs them before the
        herder's window check ever sees them)."""
        if delta == 0:
            return env
        st = env.statement
        pl = st.pledges
        t = pl.type
        if t == SX.SCPStatementType.SCP_ST_NOMINATE:
            nom = pl.nominate
            pledges = SX.SCPStatementPledges.nominate(SX.SCPNomination(
                quorumSetHash=nom.quorumSetHash,
                votes=[self._mutate_value(v, delta) for v in nom.votes],
                accepted=[self._mutate_value(v, delta)
                          for v in nom.accepted]))
        elif not self.equivocate and not force:
            return env   # conflicting-nominate only lies in nominations
        elif t == SX.SCPStatementType.SCP_ST_PREPARE:
            pr = pl.prepare
            pledges = SX.SCPStatementPledges.prepare(SX.SCPPrepare(
                quorumSetHash=pr.quorumSetHash,
                ballot=self._mutate_ballot(pr.ballot, delta),
                prepared=(self._mutate_ballot(pr.prepared, delta)
                          if pr.prepared is not None else None),
                preparedPrime=(self._mutate_ballot(pr.preparedPrime, delta)
                               if pr.preparedPrime is not None else None),
                nC=pr.nC, nH=pr.nH))
        elif t == SX.SCPStatementType.SCP_ST_CONFIRM:
            co = pl.confirm
            pledges = SX.SCPStatementPledges.confirm(SX.SCPConfirm(
                ballot=self._mutate_ballot(co.ballot, delta),
                nPrepared=co.nPrepared, nCommit=co.nCommit, nH=co.nH,
                quorumSetHash=co.quorumSetHash))
        else:
            ex = pl.externalize
            pledges = SX.SCPStatementPledges.externalize(SX.SCPExternalize(
                commit=self._mutate_ballot(ex.commit, delta),
                nH=ex.nH, commitQuorumSetHash=ex.commitQuorumSetHash))
        st2 = SX.SCPStatement(nodeID=st.nodeID, slotIndex=st.slotIndex,
                              pledges=pledges)
        env2 = SX.SCPEnvelope(statement=st2, signature=b"\x00" * 64)
        self.node.herder.sign_envelope(env2)
        return env2

    # -- emission hook -----------------------------------------------------
    def _on_emit(self, env) -> None:
        self._emitted.append(env)
        if not (self.equivocate or self.conflicting_nominate):
            # truthful consensus traffic still floods normally
            self._orig_broadcast(env)
        else:
            variants: Dict[int, object] = {}
            for peer in list(self.node.overlay._auth_peer_list()):
                g = self._group_of(peer.peer_id)
                out = variants.get(g)
                if out is None:
                    out = variants[g] = self._variant(env, g)
                peer.send_message(X.StellarMessage.envelope(out))
                if out is not env:
                    # count only genuinely equivocal sends — in
                    # conflicting-nominate-only mode ballot statements
                    # pass through unmutated even for non-zero groups
                    self.stats["equivocal_sent"] += 1
        if self.stale_replay:
            self._replay_stale(env.statement.slotIndex)

    def _replay_stale(self, live_slot: int) -> None:
        """Re-send properly-signed statements for slots older than the
        fleet's slot memory.  Each replay carries a FRESH value delta:
        a byte-identical replay dies in the receivers' floodgate dedup
        (a fine first line of defense, but silent), while a never-seen
        statement for a dead slot must reach the herder and be binned by
        the MAX_SLOTS_TO_REMEMBER window check — the observable,
        metered discard path this fault exists to exercise."""
        stale = [e for e in self._emitted
                 if e.statement.slotIndex <= live_slot - self.STALE_GAP]
        for env in stale[-self.REPLAYS_PER_EMIT:]:
            self._replay_seq = getattr(self, "_replay_seq", 0) + 1
            out = self._variant(env, 2 + self._replay_seq % 5, force=True)
            for peer in list(self.node.overlay._auth_peer_list()):
                peer.send_message(X.StellarMessage.envelope(out))
                self.stats["stale_replayed"] += 1


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class ChaosRunner:
    """Executes one ChaosScenario on a shared VirtualClock."""

    # reconcile (redial non-severed base links lost to faults) at most
    # once per this many virtual seconds
    RECONCILE_EVERY_VT = 1.0

    def __init__(self, scenario: ChaosScenario,
                 artifact_dir: Optional[str] = None):
        self.scenario = scenario
        self.artifact_dir = artifact_dir or os.environ.get("STPU_CRASH_DIR")
        self.result = ChaosResult(scenario)
        self.sim: Optional[Simulation] = None
        self.base_links: Set[frozenset] = set()
        # name -> ("groups", [[idx,...],...]) | ("link", frozenset);
        # overlapping cuts compose: a link is severed while ANY active
        # cut severs it
        self.cuts: Dict[str, tuple] = {}
        self.banned_pairs: Set[frozenset] = set()
        # node indices turned Byzantine (ByzantineNode events): their own
        # closes are excluded from the canonical safety table — the
        # assertion must flag honest-node divergence, not the adversary's
        # bookkeeping.  index -> installed emission engine.
        self.byz_engines: Dict[int, _ByzantineEngine] = {}
        # active LinkFault state: node index (None = every node) ->
        # (damage, drop, reorder).  Kept so _reconcile can REAPPLY the
        # declared probabilities to redialed links — a damage fail-stop
        # followed by a redial must not silently clear the rest of the
        # scheduled ramp on that link.
        self.link_faults: Dict[Optional[int], Tuple[float, float, float]] = {}
        # safety bookkeeping
        self._canonical: Dict[int, bytes] = {}     # slot -> hash
        self._checked_upto: List[int] = []         # per node index
        self._node_tail: List[deque] = []
        # liveness bookkeeping
        self._lcl_sum = 0
        self._last_progress_vt = 0.0
        self._pending_recovery: Optional[dict] = None
        self._fatal = False
        self._last_reconcile_vt = -1.0
        self._start_vt = 0.0
        self._timers: List[VirtualTimer] = []

    # -- wiring ------------------------------------------------------------

    def _trace(self, msg: str) -> None:
        vt = self.sim.clock.now() - self._start_vt
        self.result.event_trace.append((round(vt, 3), msg))

    def _severed(self, ia: int, ib: int) -> bool:
        key = frozenset((ia, ib))
        if key in self.banned_pairs:
            return True
        for kind, data in self.cuts.values():
            if kind == "link":
                if key == data:
                    return True
                continue
            ga = gb = -1   # -1 = implicit remainder group
            for gi, grp in enumerate(data):
                if ia in grp:
                    ga = gi
                if ib in grp:
                    gb = gi
            if ga != gb:
                return True
        return False

    def _reconcile(self) -> None:
        """Drive connectivity to the desired state: base links not under
        any active cut are (re)dialed — covering links lost to corrupted
        floods / damage fail-stops — and links under a cut are severed.
        connect() is idempotent and replaces CLOSING pairs, so flapping
        schedules cannot leak half-open connections."""
        sim = self.sim
        for key in self.base_links:
            ia, ib = tuple(key)
            a, b = sim.nodes[ia], sim.nodes[ib]
            if self._severed(ia, ib):
                if sim.is_connected(a, b):
                    sim.disconnect(a, b)
            else:
                sim.connect(a, b)
                if self.link_faults:
                    # both directions, matching what a LinkFault event
                    # applies via _peers_of (the LINK is faulty, not one
                    # node's outbound half).  Most-recently-applied
                    # matching entry wins (dict order = event application
                    # order, see _apply) — a redial must restore what the
                    # LAST LinkFault left on the live link, not whichever
                    # endpoint has the lower index
                    fault = None
                    for fkey in reversed(self.link_faults):
                        if fkey is None or fkey == ia or fkey == ib:
                            fault = self.link_faults[fkey]
                            break
                    pair = sim._connections.get(
                        frozenset((a.node_id, b.node_id)))
                    if fault is not None and pair is not None:
                        for peer in pair:
                            peer.damage_probability, \
                                peer.drop_probability, \
                                peer.reorder_probability = fault
        self._last_reconcile_vt = sim.clock.now()

    # -- event application -------------------------------------------------

    def _apply(self, ev: FaultEvent) -> None:
        sim = self.sim
        self._trace(ev.describe())
        eventlog.record("Sim", "WARNING", "chaos fault",
                        scenario=self.scenario.name, event=ev.describe())
        if isinstance(ev, Partition):
            self.cuts[ev.name] = ("groups", ev.groups)
            self._reconcile()
        elif isinstance(ev, CutLink):
            self.cuts[ev.name] = ("link", frozenset((ev.a, ev.b)))
            self._reconcile()
        elif isinstance(ev, Heal):
            if ev.name is None:
                self.cuts.clear()
            else:
                self.cuts.pop(ev.name, None)
            self._reconcile()
            if ev.measure_recovery:
                self._arm_recovery()
        elif isinstance(ev, StallNode):
            self.cuts[f"stall-{ev.node}"] = ("groups", [[ev.node]])
            self._reconcile()
        elif isinstance(ev, RejoinNode):
            self.cuts.pop(f"stall-{ev.node}", None)
            self._reconcile()
            if ev.measure_recovery:
                self._arm_recovery()
        elif isinstance(ev, LinkFault):
            if ev.node is None:
                # a fleet-wide LinkFault supersedes every per-node one —
                # _apply just overwrote all live peers, so stale per-node
                # entries must not shadow this on a later redial
                self.link_faults.clear()
            # pop-then-set keeps dict order = application order, which is
            # what _reconcile's last-match-wins redial lookup relies on
            self.link_faults.pop(ev.node, None)
            self.link_faults[ev.node] = (ev.damage, ev.drop, ev.reorder)
            for peer in self._peers_of(ev.node):
                peer.damage_probability = ev.damage
                peer.drop_probability = ev.drop
                peer.reorder_probability = ev.reorder
        elif isinstance(ev, Ban):
            node, target = sim.nodes[ev.node], sim.nodes[ev.target]
            node.overlay.ban_manager.ban_node(target.node_id)
            self.banned_pairs.add(frozenset((ev.node, ev.target)))
            if sim.is_connected(node, target):
                sim.disconnect(node, target)
        elif isinstance(ev, Unban):
            node, target = sim.nodes[ev.node], sim.nodes[ev.target]
            node.overlay.ban_manager.unban_node(target.node_id)
            self.banned_pairs.discard(frozenset((ev.node, ev.target)))
            self._reconcile()
        elif isinstance(ev, CorruptFlood):
            self._corrupt_flood(ev)
        elif isinstance(ev, ByzantineNode):
            engine = self.byz_engines.get(ev.node)
            if engine is None:
                engine = self.byz_engines[ev.node] = \
                    _ByzantineEngine(self, ev.node)
            engine.enable(ev.mode, ev.groups)
        else:
            raise ValueError(f"unknown fault event {ev!r}")

    def _peers_of(self, node: Optional[int]):
        """Both directions of every live loopback link touching `node`
        (all links when None)."""
        for key, pair in list(self.sim._connections.items()):
            if node is not None:
                nid = self.sim.nodes[node].node_id
                if nid not in key:
                    continue
            yield from pair

    def _corrupt_flood(self, ev: CorruptFlood) -> None:
        from .. import xdr as X
        node = self.sim.nodes[ev.node]
        sent = 0
        for key, pair in list(self.sim._connections.items()):
            if node.node_id not in key:
                continue
            for peer in pair:
                if peer.overlay is not node.overlay:
                    continue
                if not peer.is_authenticated():
                    continue
                saved = peer.damage_probability
                peer.damage_probability = 1.0
                try:
                    for _ in range(ev.frames):
                        peer.send_message(X.StellarMessage.getPeers())
                        sent += 1
                finally:
                    peer.damage_probability = saved
        self._trace(f"corrupt-flood sent {sent} damaged frames "
                    f"from node {ev.node}")

    # -- assertions --------------------------------------------------------

    def _close_target(self) -> float:
        return float(self.sim.nodes[0].herder.ledger_timespan)

    def _honest_validators(self) -> List[SimNode]:
        return [n for i, n in enumerate(self.sim.nodes)
                if n.herder.is_validator and i not in self.byz_engines]

    def _arm_recovery(self) -> None:
        vs = self._honest_validators()
        target = max(n.lcl for n in vs) + 1
        self._pending_recovery = {
            "heal_vt": self.sim.clock.now(),
            "target_slot": target,
            "deadline": self.sim.clock.now()
            + self.scenario.recovery_close_targets * self._close_target(),
        }
        self._trace(f"recovery armed: converge at slot >= {target}")

    def _stall_allowed(self, vt: float) -> bool:
        return any(t0 <= vt <= t1 for t0, t1 in self.scenario.allow_stall)

    def _violate(self, kind: str, detail: str) -> None:
        vt = self.sim.clock.now() - self._start_vt
        self.result.violations.append(Violation(kind, vt, detail))
        self._trace(f"VIOLATION[{kind}] {detail}")
        log.error("chaos %s violation in %r at vt=%.1f: %s",
                  kind, self.scenario.name, vt, detail)
        eventlog.record("Sim", "ERROR", "chaos violation",
                        scenario=self.scenario.name, kind=kind,
                        detail=detail)
        self._fatal = True

    def _observe(self) -> bool:
        """Ran every crank: safety over newly-closed slots, liveness
        stall detection, recovery convergence.  Returns True to stop
        cranking (fatal violation or campaign complete)."""
        sim = self.sim
        now = sim.clock.now()
        nodes = sim.nodes
        lcl_sum = 0
        for idx, node in enumerate(nodes):
            lcl = node.lcl
            lcl_sum += lcl
            upto = self._checked_upto[idx]
            if lcl > upto:
                closed = node.closed
                byz = idx in self.byz_engines
                for slot in range(upto + 1, lcl + 1):
                    h = closed.get(slot)
                    if h is None:
                        continue   # genesis/assumed state, nothing to check
                    if byz:
                        # an adversarial validator's own closes neither
                        # define nor violate the canonical chain — the
                        # safety assertion is about the HONEST fleet
                        self._node_tail[idx].append(
                            (round(now - self._start_vt, 2), slot,
                             h.hex()[:16]))
                        continue
                    canon = self._canonical.get(slot)
                    if canon is None:
                        self._canonical[slot] = h
                    elif canon != h:
                        self._violate(
                            "safety",
                            f"node {idx} externalized {h.hex()[:16]} at "
                            f"slot {slot}, network externalized "
                            f"{canon.hex()[:16]}")
                    self._node_tail[idx].append(
                        (round(now - self._start_vt, 2), slot, h.hex()[:16]))
                self._checked_upto[idx] = lcl
        if lcl_sum > self._lcl_sum:
            self._lcl_sum = lcl_sum
            self._last_progress_vt = now
        else:
            stalled_for = now - self._last_progress_vt
            grace = self.scenario.liveness_grace_targets \
                * self._close_target()
            if stalled_for > grace \
                    and not self._stall_allowed(now - self._start_vt):
                self._violate(
                    "liveness",
                    f"no ledger closed anywhere for {stalled_for:.1f}s "
                    f"virtual (> {grace:.0f}s grace); quorum lost?")
        rec = self._pending_recovery
        if rec is not None:
            vs = self._honest_validators()
            target = rec["target_slot"]
            if all(n.lcl >= target for n in vs):
                hashes = {n.closed.get(target) for n in vs}
                if len(hashes) == 1 and None not in hashes:
                    recovery_s = now - rec["heal_vt"]
                    self.result.recoveries.append({
                        "heal_vt": round(rec["heal_vt"] - self._start_vt, 2),
                        "recovery_s": recovery_s,
                        "slot": target,
                    })
                    self._trace(f"recovered in {recovery_s:.1f}s virtual "
                                f"(slot {target})")
                    self._pending_recovery = None
            if self._pending_recovery is not None \
                    and now > rec["deadline"]:
                spread = sorted({n.lcl for n in vs})
                self._violate(
                    "recovery",
                    f"no convergence at slot {target} within "
                    f"{self.scenario.recovery_close_targets:g} close "
                    f"targets after heal (lcl spread {spread[:5]}..)")
        if self._fatal:
            return True
        if now - self._last_reconcile_vt >= self.RECONCILE_EVERY_VT:
            self._reconcile()
        done = now >= self._start_vt + self.scenario.duration_s
        return done and self._pending_recovery is None

    # -- artifacts ---------------------------------------------------------

    def _node_record(self, idx: int, node: SimNode) -> dict:
        health = node.evaluate_health()
        rec = {
            "node": idx,
            "id": node.node_id.hex()[:16],
            "lcl": node.lcl,
            "lcl_hash": node.lcl_hash.hex()[:16],
            "herder_state": node.herder.get_state_human(),
            "recovery_stats": dict(node.herder.recovery_stats),
            "authenticated_peers": node.overlay.num_authenticated(),
            "health": health["status"],
            "health_reasons": health["reasons"],
            "recent_closes": list(self._node_tail[idx]),
        }
        engine = self.byz_engines.get(idx)
        if engine is not None:
            rec["byzantine"] = dict(engine.stats)
        return rec

    def _emit_artifacts(self, reason: str) -> None:
        res = self.result
        res.node_records = [self._node_record(i, n)
                            for i, n in enumerate(self.sim.nodes)]
        if not self.artifact_dir:
            return
        eventlog.register_bundle_source("chaos", lambda: {
            "scenario": self.scenario.name,
            "seed": self.scenario.seed,
            "schedule": [ev.describe() for ev in self.scenario.schedule],
            "violations": [v.to_dict() for v in res.violations],
        })
        try:
            res.crash_bundle_path = eventlog.write_crash_bundle(
                reason, crash_dir=self.artifact_dir)
        finally:
            eventlog.unregister_bundle_source("chaos")
        # the merged cross-node trace: every SimNode shares this process,
        # so the phase-mark buffer splits per node attribution into the
        # same row-per-node Chrome trace shape the fleet soak emits
        trace_path = os.path.join(
            self.artifact_dir,
            f"chaos-{self.scenario.name}-seed{self.scenario.seed}"
            "-trace.json")
        os.makedirs(self.artifact_dir, exist_ok=True)
        from ..util.fleettrace import merge_local_trace
        trace_events = merge_local_trace(trace_path)
        artifact = {
            "scenario": self.scenario.name,
            "description": self.scenario.description,
            "reason": reason,
            "seed": self.scenario.seed,
            "replay": f"ChaosRunner(scenario with seed={self.scenario.seed})"
                      " — the seed threads into every loopback fault RNG",
            "schedule": [ev.describe() for ev in self.scenario.schedule],
            "violations": [v.to_dict() for v in res.violations],
            "event_trace": res.event_trace,
            "node_records": res.node_records,
            "crash_bundle": res.crash_bundle_path,
            "merged_trace": trace_path,
            "merged_trace_events": trace_events,
        }
        path = os.path.join(
            self.artifact_dir,
            f"chaos-{self.scenario.name}-seed{self.scenario.seed}.json")
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1, default=str)
        res.artifact_path = path
        log.warning("chaos scenario %r failed: %s -> %s",
                    self.scenario.name, reason, path)

    # -- main entry --------------------------------------------------------

    def run(self) -> ChaosResult:
        """Execute the campaign.  Scenario-scoped environment — the
        checkpoint cadence (archive format, process-global) and any
        provisioned on-disk state — is installed before build and
        restored afterwards, so campaigns compose in one process."""
        sc = self.scenario
        prev_freq = None
        if sc.checkpoint_frequency is not None:
            from ..history import archive as _arch
            prev_freq = _arch.checkpoint_frequency()
            _arch.set_checkpoint_frequency(sc.checkpoint_frequency)
        try:
            return self._run_campaign()
        finally:
            if prev_freq is not None:
                from ..history import archive as _arch
                _arch.set_checkpoint_frequency(prev_freq)
            if sc.cleanup is not None:
                try:
                    sc.cleanup()
                except OSError:   # teardown best-effort; artifacts are out
                    pass

    def _run_campaign(self) -> ChaosResult:
        sc = self.scenario
        self.sim, self.base_links = sc.build(sc.seed)
        sim = self.sim
        # transport mode is campaign-scoped: set before any link is
        # dialed so every peer negotiates (or declines) batching
        sim.batching = sc.batching
        for node in sim.nodes:
            node.overlay.batching = sc.batching
        n = len(sim.nodes)
        self.result.nodes = n
        self._checked_upto = [0] * n
        self._node_tail = [deque(maxlen=NODE_RECORD_TAIL) for _ in range(n)]
        eventlog.record("Sim", "INFO", "chaos scenario start",
                        scenario=sc.name, nodes=n, seed=sc.seed,
                        events=len(sc.schedule))
        for key in self.base_links:
            ia, ib = tuple(key)
            sim.connect(sim.nodes[ia], sim.nodes[ib])
        sim.start_all_nodes(mesh=False)
        self._start_vt = sim.clock.now()
        self._last_progress_vt = self._start_vt
        self._last_reconcile_vt = self._start_vt

        # expand Flaps, then arm one virtual timer per event
        events: List[FaultEvent] = []
        for ev in sc.schedule:
            events.extend(ev.expand() if isinstance(ev, Flap) else [ev])
        events.sort(key=lambda e: e.at)
        for ev in events:
            t = VirtualTimer(sim.clock)
            t.expires_at(self._start_vt + ev.at,
                         lambda e=ev: self._apply(e))
            self._timers.append(t)

        # crank the campaign; generous wall-clock-free virtual timeout —
        # duration plus the recovery budget plus slack for armed timers
        budget = sc.duration_s \
            + (sc.recovery_close_targets + 4) * self._close_target()
        finished = sim.crank_until(self._observe, timeout=budget)
        if not finished and not self._fatal:
            if self._pending_recovery is not None:
                self._violate("recovery",
                              "campaign ended before post-heal convergence")
            else:
                self._violate("timeout",
                              f"campaign did not complete within "
                              f"{budget:.0f}s virtual")
        self.result.ledgers_closed = max(self._canonical, default=1) - 1
        self.result.slot_hashes = dict(self._canonical)
        self.result.virtual_s = sim.clock.now() - self._start_vt
        if not self.result.passed:
            kinds = {v.kind for v in self.result.violations}
            self._emit_artifacts(
                f"chaos scenario {sc.name!r}: {', '.join(sorted(kinds))} "
                f"violation")
        else:
            self.result.node_records = [self._node_record(i, node)
                                        for i, node in enumerate(sim.nodes)]
        eventlog.record("Sim", "INFO", "chaos scenario end",
                        scenario=sc.name, passed=self.result.passed,
                        ledgers=self.result.ledgers_closed)
        sim.clock.stop()
        return self.result


def run_scenario(scenario: ChaosScenario,
                 artifact_dir: Optional[str] = None) -> ChaosResult:
    return ChaosRunner(scenario, artifact_dir=artifact_dir).run()


# ---------------------------------------------------------------------------
# scenario catalogue
# ---------------------------------------------------------------------------

def _hier_build(n_orgs: int, nodes_per_org: int = 3
                ) -> Callable[[int], Tuple[Simulation, Set[frozenset]]]:
    def build(seed: int):
        sim = make_hierarchical_topology(n_orgs, nodes_per_org, seed=seed)
        return sim, hierarchical_links(n_orgs, nodes_per_org)
    return build


def _core_build(n: int) -> Callable[[int], Tuple[Simulation, Set[frozenset]]]:
    def build(seed: int):
        return make_core_topology(n, seed=seed), mesh_links(n)
    return build


def _cycle_build(n: int) -> Callable[[int], Tuple[Simulation, Set[frozenset]]]:
    def build(seed: int):
        return make_cycle_topology(n, seed=seed), ring_links(n)
    return build


def _asym_build(n_core_orgs: int, nodes_per_org: int, n_leaf: int
                ) -> Callable[[int], Tuple[Simulation, Set[frozenset]]]:
    def build(seed: int):
        sim = make_asymmetric_topology(n_core_orgs, nodes_per_org, n_leaf,
                                       seed=seed)
        return sim, asymmetric_links(n_core_orgs, nodes_per_org, n_leaf)
    return build


def scenario_partition_flap_heal(n_orgs: int = 17, nodes_per_org: int = 3,
                                 seed: int = 7) -> ChaosScenario:
    """The flagship: a minority org block is partitioned away, the cut
    flaps (heal/sever alternation), then heals for good — the majority
    must keep closing throughout, nobody may fork, and the whole fleet
    must reconverge within the recovery budget."""
    minority = [i for o in range(max(1, n_orgs // 4))
                for i in org_indices(o, nodes_per_org)]
    return ChaosScenario(
        name=f"partition-flap-heal-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[
            Partition(12.0, [minority], name="minority"),
            Heal(22.0, name="minority"),
            Flap(26.0, [minority], period=3.0, count=2, name="flap"),
            Heal(40.0, name=None, measure_recovery=True),
        ],
        duration_s=55.0,
        seed=seed,
        description="minority partition -> flapping cut -> heal; "
                    "safety + majority liveness + bounded recovery")


def scenario_quorum_split(n_orgs: int = 4, nodes_per_org: int = 3,
                          seed: int = 11) -> ChaosScenario:
    """INTENTIONALLY BROKEN: a clean half/half org split leaves neither
    side a 2/3-of-orgs quorum, so the whole network stalls.  The runner
    must DETECT this as a liveness violation and emit the replayable
    artifact — this scenario existing (and failing) is the proof the
    assertions have teeth."""
    half = [i for o in range(n_orgs // 2)
            for i in org_indices(o, nodes_per_org)]
    return ChaosScenario(
        name=f"quorum-split-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[Partition(8.0, [half], name="split")],
        duration_s=70.0,
        seed=seed,
        liveness_grace_targets=6.0,
        expect_failure="liveness",
        description="half/half org split: no side retains quorum; the "
                    "runner must flag the global stall as a liveness "
                    "failure")


def scenario_link_degradation(n: int = 12, seed: int = 3) -> ChaosScenario:
    """Per-link fault probability ramp: drop and reorder climb across all
    links, then a burst of damaged frames (MAC fail-stops), then clean.
    Consensus must survive the whole ramp without forking or stalling."""
    return ChaosScenario(
        name=f"link-degradation-{n}",
        build=_core_build(n),
        schedule=[
            LinkFault(8.0, drop=0.02, reorder=0.05),
            LinkFault(16.0, drop=0.05, reorder=0.10),
            LinkFault(24.0, drop=0.10, reorder=0.15),
            LinkFault(32.0, damage=0.02, drop=0.05),
            LinkFault(40.0),   # all probabilities back to zero
        ],
        duration_s=50.0,
        seed=seed,
        liveness_grace_targets=10.0,
        description="drop/reorder probability ramp + damage burst over "
                    "every link of a core mesh")


def scenario_stall_rejoin(n_orgs: int = 4, nodes_per_org: int = 3,
                          seed: int = 5) -> ChaosScenario:
    """One validator is isolated long past the peers' slot memory, then
    rejoins: it must come back through buffered-externalize / out-of-sync
    SCP-state recovery and the fleet must reconverge."""
    return ChaosScenario(
        name=f"stall-rejoin-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[
            StallNode(10.0, node=0),
            RejoinNode(45.0, node=0, measure_recovery=True),
        ],
        duration_s=60.0,
        seed=seed,
        description="validator stall past slot memory + rejoin through "
                    "buffered-ledger recovery")


def scenario_corrupt_flood(n_orgs: int = 4, nodes_per_org: int = 3,
                           seed: int = 13) -> ChaosScenario:
    """A node floods damaged frames (receivers must fail-stop, never
    apply), gets banned by a victim, later unbanned; the mesh redials
    and consensus never forks."""
    return ChaosScenario(
        name=f"corrupt-flood-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[
            CorruptFlood(10.0, node=1, frames=2),
            Ban(14.0, node=4, target=1),
            CorruptFlood(20.0, node=1, frames=2),
            Unban(30.0, node=4, target=1),
            Heal(34.0, measure_recovery=True),
        ],
        duration_s=48.0,
        seed=seed,
        description="corrupted floods fail-stop connections; ban/unban; "
                    "mesh heals and reconverges")


def scenario_cycle_partition(n: int = 12, seed: int = 17) -> ChaosScenario:
    """Ring topology: sever individual ring links (the overlay graph
    stays connected through the remaining chords, so flooding reroutes)
    and heal — the reference uses cycle topologies for exactly this
    connectivity-limited liveness testing.  A *group* partition is
    deliberately NOT used here: a cycle's 2-of-3 neighbour slices lack
    global quorum intersection, so splitting the graph can fork
    legitimately (the safety checker catches it)."""
    return ChaosScenario(
        name=f"cycle-partition-{n}",
        build=_cycle_build(n),
        schedule=[
            CutLink(10.0, 0, 1),
            CutLink(12.0, 0, 2),
            CutLink(14.0, n // 2, n // 2 + 1),
            Heal(24.0, name=None, measure_recovery=True),
        ],
        duration_s=45.0,
        seed=seed,
        description="ring link cuts (graph stays connected) + heal")


def scenario_asym_tier_partition(n_core_orgs: int = 4,
                                 nodes_per_org: int = 3,
                                 n_leaf: int = 6,
                                 seed: int = 19) -> ChaosScenario:
    """Asymmetric tiers: partition the leaf tier away from the core (the
    core keeps closing — leaves are in nobody's slices), heal, and the
    leaves must catch back up."""
    n_core = n_core_orgs * nodes_per_org
    leaves = list(range(n_core, n_core + n_leaf))
    return ChaosScenario(
        name=f"asym-tier-partition-{n_core + n_leaf}",
        build=_asym_build(n_core_orgs, nodes_per_org, n_leaf),
        schedule=[
            Partition(10.0, [leaves], name="leaf-cut"),
            Heal(30.0, name="leaf-cut", measure_recovery=True),
        ],
        duration_s=48.0,
        seed=seed,
        description="second-tier validators cut from the tier-1 core, "
                    "then healed; core liveness unaffected")


def scenario_byzantine_equivocation(n_orgs: int = 4, nodes_per_org: int = 3,
                                    seed: int = 31) -> ChaosScenario:
    """Byzantine SCP traffic in a HEALTHY-intersection hierarchical
    topology: one signing validator equivocates (different value to
    different peers for the same slot/ballot), later starts replaying
    its own stale-slot envelopes, and a second validator emits
    conflicting nominations.  Because quorum intersection holds, every
    quorum crosses the equivocation groups — honest nodes must never
    externalize divergent hashes and the fleet must keep closing (SCP's
    safety claim under Byzantine faults, PAPER.md).  Stale replays must
    die at the receivers' slot-memory window check
    (herder.scp.envelope-discarded)."""
    return ChaosScenario(
        name=f"byzantine-equivocation-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[
            ByzantineNode(8.0, node=1, mode="equivocate"),
            # node 3 = org 1's ring node: it carries inter-org links, so
            # its conflicting nominations actually cross the org boundary
            ByzantineNode(20.0, node=3, mode="conflicting-nominate"),
            ByzantineNode(70.0, node=1, mode="stale-replay"),
        ],
        duration_s=95.0,
        seed=seed,
        liveness_grace_targets=10.0,
        description="equivocation + conflicting nominations + stale "
                    "replays from signing validators; healthy "
                    "intersection, so honest nodes must not fork")


def scenario_intersection_violation(group_size: int = 2,
                                    seed: int = 37) -> ChaosScenario:
    """INTENTIONALLY BROKEN: the generated intersection-violation
    topology (two disjoint near-quorums bridged by one validator) plus
    that bridge equivocating — side A hears value X, side B hears X+1 —
    makes both sides commit different values for the same slot.  The
    per-crank safety assertion MUST flag the fork (attributing it to the
    divergent honest closes, never to the adversary's own bookkeeping)
    and emit the replayable artifact.  This is the scenario axis the
    survey's quorum-intersection precondition exists for: one shared
    node is exactly one Byzantine failure away from a fork."""
    n = 2 * group_size + 1
    bridge = n - 1
    b_side = list(range(group_size, 2 * group_size))
    return ChaosScenario(
        name=f"intersection-violation-{n}",
        build=lambda seed_: (
            make_intersection_violation_topology(group_size, seed=seed_),
            split_brain_links(group_size)),
        schedule=[ByzantineNode(6.0, node=bridge, mode="equivocate",
                                groups=[b_side])],
        duration_s=45.0,
        seed=seed,
        liveness_grace_targets=10.0,
        expect_failure="safety",
        description="two disjoint near-quorums + an equivocating bridge: "
                    "the runner must flag the fork as a safety failure")


def scenario_archive_recovery(n_orgs: int = 4, nodes_per_org: int = 3,
                              seed: int = 29,
                              archive_dir: Optional[str] = None,
                              parallel: int = 1) -> ChaosScenario:
    """The most common real-world incident shape, end to end IN-SIM: a
    validator is stalled well past ``MAX_SLOTS_TO_REMEMBER`` while the
    healthy fleet publishes REAL checkpoints to a shared archive
    (accelerated cadence, the fleet harness's 8); at rejoin the
    SCP-state pull dead-ends (nobody remembers the slots it needs), the
    herder's sync-gap signal hands off to real archive catchup
    (hash-verified chain + bucket apply + replay; ``parallel`` > 1 runs
    the range-parallel worker path), the node adopts the verified state
    and re-tracks through the buffered-externalize bridge."""
    last = n_orgs * nodes_per_org - 1
    state = {"tmp": None}

    def build(seed_: int):
        sim = make_hierarchical_topology(n_orgs, nodes_per_org, seed=seed_)
        from ..history.archive import FileHistoryArchive
        root = archive_dir
        if root is None:
            import tempfile
            root = state["tmp"] = tempfile.mkdtemp(prefix="chaos-archive-")
        archive = FileHistoryArchive(root)
        for i, node in enumerate(sim.nodes):
            # org 0 publishes (identical bytes from each — the archive
            # write path is atomic + content-addressed); EVERY node can
            # read it for catchup
            node.attach_history(archive, publish=(i < nodes_per_org),
                                parallel=(parallel if i == last else 1))
        return sim, hierarchical_links(n_orgs, nodes_per_org)

    sc = ChaosScenario(
        name=f"archive-recovery-{n_orgs * nodes_per_org}",
        build=build,
        schedule=[
            StallNode(10.0, node=last),
            RejoinNode(85.0, node=last, measure_recovery=True),
        ],
        duration_s=100.0,
        seed=seed,
        checkpoint_frequency=8,
        recovery_close_targets=14.0,
        description="validator stalled past slot memory; rejoin must "
                    "hand off to real archive catchup and re-track")

    def cleanup():
        if state["tmp"] is not None:
            import shutil
            shutil.rmtree(state["tmp"], ignore_errors=True)
            state["tmp"] = None
    sc.cleanup = cleanup
    return sc


def scenario_soak(n_orgs: int = 50, nodes_per_org: int = 3,
                  seed: int = 23, duration_s: float = 45.0
                  ) -> ChaosScenario:
    """The soak: a large hierarchical fleet through link degradation, a
    Byzantine equivocator, partition, a stalled validator, flapping and
    a measured heal — every fault class in one compressed schedule.
    Default 150 nodes (the -m slow tier, ~4 min wall); 300 nodes
    (`n_orgs=100`) runs the same schedule and, since the incremental
    per-slot quorum state landed (scp/quorum.StatementIndex), completes
    in ~19 min wall instead of offline-scale hours — the remaining
    floor is per-link transport (~n^2 deliveries)."""
    minority = [i for o in range(max(1, n_orgs // 5))
                for i in org_indices(o, nodes_per_org)]
    last = n_orgs * nodes_per_org - 1
    return ChaosScenario(
        name=f"soak-{n_orgs * nodes_per_org}",
        build=_hier_build(n_orgs, nodes_per_org),
        schedule=[
            LinkFault(6.0, drop=0.02, reorder=0.05),
            # a signing validator outside the partitioned minority turns
            # equivocator for the whole campaign: intersection holds, so
            # the honest fleet must shrug it off under every other fault
            ByzantineNode(8.0, node=n_orgs * nodes_per_org // 2,
                          mode="equivocate"),
            Partition(10.0, [minority], name="minority"),
            StallNode(12.0, node=last),
            Heal(25.0, name="minority"),
            Flap(28.0, [minority], period=3.0, count=1, name="flap"),
            RejoinNode(36.0, node=last),
            LinkFault(38.0),
            Heal(40.0, measure_recovery=True),
        ],
        duration_s=duration_s,
        seed=seed,
        recovery_close_targets=16.0,
        description="soak: every fault class incl. a byzantine "
                    "equivocator in one schedule")


# small-topology tier (tier-1-eligible) and the full
# catalogue (300-node soaks ride behind -m slow).  Each entry is
# (factory, est_wall_s): the estimate is a wall-clock budget, and the
# list is the single enumeration of the campaigns (cheapest first).
SMALL_SCENARIOS: List[Tuple[Callable[[], ChaosScenario], float]] = [
    (lambda: scenario_stall_rejoin(4, 3), 8.0),
    (lambda: scenario_corrupt_flood(4, 3), 8.0),
    (lambda: scenario_cycle_partition(12), 10.0),
    (lambda: scenario_link_degradation(12), 12.0),
    (lambda: scenario_asym_tier_partition(4, 3, 6), 12.0),
    (lambda: scenario_byzantine_equivocation(4, 3), 15.0),
    (lambda: scenario_archive_recovery(4, 3), 20.0),
    (lambda: scenario_partition_flap_heal(17, 3), 60.0),
]

SOAK_SCENARIOS: List[Tuple[Callable[[], ChaosScenario], float]] = [
    (lambda: scenario_partition_flap_heal(34, 3), 150.0),   # 102 nodes
    (lambda: scenario_soak(50, 3), 240.0),                  # 150 nodes
    (lambda: scenario_soak(100, 3), 1150.0),                # 300 nodes
    # the 300-node soak moved from offline-scale (hours) to ~19 min
    # when the incremental per-slot quorum state landed; the test suite
    # still gates it behind STPU_CHAOS_SOAK_ORGS=100
    # so the default -m slow run stays under ten minutes total
]
