"""Test helpers for the tests and chip_smoke.py, on the port's types.

* Transaction builders and ``TestAccount`` (reference: src/test/TxTests
  and TestAccount), copies of stellar_core_tpu/testutils.py's: payment,
  account, trust, offer, path-payment, pool and Soroban operations,
  ``build_tx``, ``network_id`` and ``for_all_versions``.
* Quorum maps: copies of ``stellar_core_tpu.testutils.asym_org_qmap``,
  the ``org_qmap`` and flat maps of tests/test_accel_quorum.py, and
  bench.py's ``tier1_quorum_map`` and ``adversarial_quorum_map``.  Node
  ids are byte for byte the reference's, so two checkers' splits compare
  as node lists.
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import xdr as X
from .crypto.keys import SecretKey
from .crypto.sha import sha256
from .transactions.frame import TransactionFrame
from .xdr.scp import NodeID, SCPQuorumSet


def native_payment_op(dest: X.AccountID, amount: int,
                      source: Optional[X.AccountID] = None) -> X.Operation:
    return X.Operation(
        sourceAccount=(X.muxed_from_account_id(source)
                       if source is not None else None),
        body=X.OperationBody.paymentOp(X.PaymentOp(
            destination=X.muxed_from_account_id(dest),
            asset=X.Asset.native(), amount=amount)))


def create_account_op(dest: X.AccountID, starting_balance: int,
                      source: Optional[X.AccountID] = None) -> X.Operation:
    return X.Operation(
        sourceAccount=(X.muxed_from_account_id(source)
                       if source is not None else None),
        body=X.OperationBody.createAccountOp(X.CreateAccountOp(
            destination=dest, startingBalance=starting_balance)))


def build_tx(network_id: bytes, source: SecretKey, seq_num: int,
             ops: Sequence[X.Operation], fee: Optional[int] = None,
             memo: Optional[X.Memo] = None,
             time_bounds: Optional[X.TimeBounds] = None,
             extra_signers: Sequence[SecretKey] = (),
             signers: Optional[Sequence[SecretKey]] = None,
             soroban_data=None) -> TransactionFrame:
    """Build + sign a v1 envelope (reference: TxTests — transactionFromOps).
    `signers` overrides the signing set entirely (e.g. a multisig tx signed
    only by an added signer, not the master key)."""
    tx = X.Transaction(
        sourceAccount=X.MuxedAccount.ed25519(source.public_key.ed25519),
        fee=fee if fee is not None else 100 * len(ops),
        seqNum=seq_num,
        cond=(X.Preconditions.timeBounds(time_bounds)
              if time_bounds is not None else X.Preconditions.none()),
        memo=memo if memo is not None else X.Memo.none(),
        operations=list(ops))
    if soroban_data is not None:
        tx.ext = X.TransactionExt.sorobanData(soroban_data)
    env = X.TransactionEnvelope.v1(
        X.TransactionV1Envelope(tx=tx, signatures=[]))
    frame = TransactionFrame(network_id, env)
    payload_hash = frame.content_hash()
    signing_set = (tuple(signers) if signers is not None
                   else (source, *extra_signers))
    for signer in signing_set:
        env.value.signatures.append(X.DecoratedSignature(
            hint=signer.public_key.hint(),
            signature=signer.sign(payload_hash)))
    return frame


class TestAccount:
    """Sequence-tracking account handle (reference: src/test/TestAccount.h)."""

    __test__ = False  # not a pytest collection target

    def __init__(self, mgr, secret: SecretKey, seq_num: int):
        self.mgr = mgr
        self.secret = secret
        self.seq_num = seq_num

    @property
    def account_id(self) -> X.AccountID:
        return X.AccountID.ed25519(self.secret.public_key.ed25519)

    def next_seq(self) -> int:
        self.seq_num += 1
        return self.seq_num

    def tx(self, ops: Sequence[X.Operation], **kwargs) -> TransactionFrame:
        return build_tx(self.mgr.network_id, self.secret, self.next_seq(),
                        ops, **kwargs)


def network_id(passphrase: str) -> bytes:
    """networkID = SHA256(passphrase) (reference: src/main/Config.cpp)."""
    return sha256(passphrase.encode())


TESTNET_PASSPHRASE = "Test SDF Network ; September 2015"


# --- offer / trust / path-payment / pool op builders ----------------------

def make_asset(code: str, issuer: X.AccountID) -> X.Asset:
    raw = code.encode()
    if len(raw) <= 4:
        return X.Asset.alphaNum4(X.AlphaNum4(
            assetCode=raw.ljust(4, b"\x00"), issuer=issuer))
    return X.Asset.alphaNum12(X.AlphaNum12(
        assetCode=raw.ljust(12, b"\x00"), issuer=issuer))


def _src(source):
    return (X.muxed_from_account_id(source) if source is not None else None)


def change_trust_op(asset: X.Asset, limit: int = 2**63 - 1,
                    source=None) -> X.Operation:
    line = X.ChangeTrustAsset(asset.switch, asset.value)
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.changeTrustOp(
                           X.ChangeTrustOp(line=line, limit=limit)))


def change_trust_pool_op(asset_a: X.Asset, asset_b: X.Asset,
                         limit: int = 2**63 - 1, fee: int = 30,
                         source=None) -> X.Operation:
    params = X.LiquidityPoolParameters.constantProduct(
        X.LiquidityPoolConstantProductParameters(
            assetA=asset_a, assetB=asset_b, fee=fee))
    line = X.ChangeTrustAsset.liquidityPool(params)
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.changeTrustOp(
                           X.ChangeTrustOp(line=line, limit=limit)))


def payment_op(dest: X.AccountID, asset: X.Asset, amount: int,
               source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.paymentOp(X.PaymentOp(
                           destination=X.muxed_from_account_id(dest),
                           asset=asset, amount=amount)))


def manage_sell_offer_op(selling: X.Asset, buying: X.Asset, amount: int,
                         price_n: int, price_d: int, offer_id: int = 0,
                         source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.manageSellOfferOp(
                           X.ManageSellOfferOp(
                               selling=selling, buying=buying, amount=amount,
                               price=X.Price(n=price_n, d=price_d),
                               offerID=offer_id)))


def manage_buy_offer_op(selling: X.Asset, buying: X.Asset, buy_amount: int,
                        price_n: int, price_d: int, offer_id: int = 0,
                        source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.manageBuyOfferOp(
                           X.ManageBuyOfferOp(
                               selling=selling, buying=buying,
                               buyAmount=buy_amount,
                               price=X.Price(n=price_n, d=price_d),
                               offerID=offer_id)))


def create_passive_sell_offer_op(selling: X.Asset, buying: X.Asset,
                                 amount: int, price_n: int, price_d: int,
                                 source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.createPassiveSellOfferOp(
                           X.CreatePassiveSellOfferOp(
                               selling=selling, buying=buying, amount=amount,
                               price=X.Price(n=price_n, d=price_d))))


def path_payment_strict_receive_op(send_asset: X.Asset, send_max: int,
                                   dest: X.AccountID, dest_asset: X.Asset,
                                   dest_amount: int, path=(),
                                   source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.pathPaymentStrictReceiveOp(
                           X.PathPaymentStrictReceiveOp(
                               sendAsset=send_asset, sendMax=send_max,
                               destination=X.muxed_from_account_id(dest),
                               destAsset=dest_asset, destAmount=dest_amount,
                               path=list(path))))


def path_payment_strict_send_op(send_asset: X.Asset, send_amount: int,
                                dest: X.AccountID, dest_asset: X.Asset,
                                dest_min: int, path=(),
                                source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.pathPaymentStrictSendOp(
                           X.PathPaymentStrictSendOp(
                               sendAsset=send_asset, sendAmount=send_amount,
                               destination=X.muxed_from_account_id(dest),
                               destAsset=dest_asset, destMin=dest_min,
                               path=list(path))))


def liquidity_pool_deposit_op(pool_id: bytes, max_a: int, max_b: int,
                              min_price=(1, 10**7), max_price=(10**7, 1),
                              source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.liquidityPoolDepositOp(
                           X.LiquidityPoolDepositOp(
                               liquidityPoolID=pool_id,
                               maxAmountA=max_a, maxAmountB=max_b,
                               minPrice=X.Price(n=min_price[0], d=min_price[1]),
                               maxPrice=X.Price(n=max_price[0], d=max_price[1]))))


def liquidity_pool_withdraw_op(pool_id: bytes, amount: int, min_a: int = 0,
                               min_b: int = 0, source=None) -> X.Operation:
    return X.Operation(sourceAccount=_src(source),
                       body=X.OperationBody.liquidityPoolWithdrawOp(
                           X.LiquidityPoolWithdrawOp(
                               liquidityPoolID=pool_id, amount=amount,
                               minAmountA=min_a, minAmountB=min_b)))


# --- protocol version sweep (reference: src/test/TxTests — for_all_versions)

SUPPORTED_PROTOCOL_RANGE = range(10, 24)   # earliest gated .. current


def for_all_versions(network_id: bytes, body, versions=None) -> None:
    """Run `body(mgr, version)` against a fresh genesis ledger at every
    protocol level (reference: for_all_versions in TxTests — apply-time
    behavior must be checked under each gated protocol)."""
    from .ledger.manager import LedgerManager
    for version in (versions or SUPPORTED_PROTOCOL_RANGE):
        mgr = LedgerManager(network_id)
        mgr.start_new_ledger(protocol_version=version)
        body(mgr, version)


# --- Soroban tx builders (reference: src/test/TxTests — sorobanTransactionFrameFromOps)

def contract_address(tag: int) -> "X.SCAddress":
    """Deterministic contract address from a small integer tag."""
    return X.SCAddress.contractId(bytes([tag]) * 32)


def invoke_op(contract: "X.SCAddress", fname: str,
              args: Sequence["X.SCVal"], source=None) -> X.Operation:
    return X.Operation(
        sourceAccount=_src(source),
        body=X.OperationBody.invokeHostFunctionOp(X.InvokeHostFunctionOp(
            hostFunction=X.HostFunction.invokeContract(X.InvokeContractArgs(
                contractAddress=contract, functionName=fname,
                args=list(args))))))


def extend_ttl_op(extend_to: int, source=None) -> X.Operation:
    return X.Operation(
        sourceAccount=_src(source),
        body=X.OperationBody.extendFootprintTTLOp(X.ExtendFootprintTTLOp(
            ext=X.ExtensionPoint.v0(), extendTo=extend_to)))


def restore_footprint_op(source=None) -> X.Operation:
    return X.Operation(
        sourceAccount=_src(source),
        body=X.OperationBody.restoreFootprintOp(X.RestoreFootprintOp(
            ext=X.ExtensionPoint.v0())))


def make_soroban_data(read_only: Sequence["X.LedgerKey"] = (),
                      read_write: Sequence["X.LedgerKey"] = (),
                      instructions: int = 1_000_000,
                      read_bytes: int = 10_000, write_bytes: int = 10_000,
                      resource_fee: Optional[int] = None
                      ) -> "X.SorobanTransactionData":
    """Resource declaration with a fee that (by default) meets the network
    minimum for the declared resources."""
    resources = X.SorobanResources(
        footprint=X.LedgerFootprint(readOnly=list(read_only),
                                    readWrite=list(read_write)),
        instructions=instructions, readBytes=read_bytes,
        writeBytes=write_bytes)
    if resource_fee is None:
        from .soroban import network_config
        resource_fee = network_config().min_resource_fee(resources)
    return X.SorobanTransactionData(
        ext=X.ExtensionPoint.v0(), resources=resources,
        resourceFee=resource_fee)


# --- quorum maps -------------------------------------------------------


def nid(i: int) -> bytes:
    """Node id i of the test maps: two little-endian bytes, then zeros."""
    return bytes([i & 0xFF, i >> 8]) + bytes(30)


def qset(threshold, validators=(), inner=()) -> SCPQuorumSet:
    return SCPQuorumSet(threshold=threshold,
                        validators=[NodeID.ed25519(v) for v in validators],
                        innerSets=list(inner))


def flat_qmap(n: int, thr: int):
    """n nodes, each requiring thr of all n (flat40 is flat_qmap(40, 40))."""
    ids = [nid(i) for i in range(n)]
    q = qset(thr, ids)
    return {v: q for v in ids}


def org_qmap(n_orgs: int, org_size: int, top_thr: int, inner_thr: int):
    """n_orgs orgs of org_size validators; every node requires top_thr orgs,
    each satisfied by inner_thr of its members."""
    orgs = [[nid(100 * o + i) for i in range(org_size)]
            for o in range(n_orgs)]
    top = qset(top_thr, inner=[qset(inner_thr, org) for org in orgs])
    return {v: top for org in orgs for v in org}


def watched_org_qmap(n_orgs: int, org_size: int, top_thr: int,
                     inner_thr: int, watchers: int):
    """org_qmap's core and `watchers` more nodes (ids 1000, 1001, ...), each
    with a core node's qset; no node trusts a watcher, so the
    quorum-bearing SCC is the core and the search stays the core's.  Past
    256 nodes in all, a row takes more than 8 words."""
    qmap = org_qmap(n_orgs, org_size, top_thr, inner_thr)
    core = next(iter(qmap.values()))
    for j in range(watchers):
        qmap[nid(1000 + j)] = core
    return qmap


def scattered_qmap(n: int, k: int, seed: int):
    """n nodes, each with its own qset: itself and 3 random others as
    validators and k inner sets of 3 random nodes (2 of 3), a majority of
    the k + 4 entries required.  Nearly every inner set is distinct, so the
    map's flag tables grow with n k (n = 256, k = 16: too large for a
    block's shared memory)."""
    import random
    rng = random.Random(seed)
    ids = [nid(i) for i in range(n)]
    qmap = {}
    for i, v in enumerate(ids):
        others = rng.sample([u for u in ids if u != v], 3)
        inner = [qset(2, rng.sample(ids, 3)) for _ in range(k)]
        qmap[v] = qset((k + 4) // 2 + 1, [v] + others, inner)
    return qmap


def asym_org_qmap(n_orgs: int):
    """bench.py config 5's exponential class: org sizes cycle 3/4/5
    (majority inner thresholds) and each org's nodes carry a distinct qset
    (the org list rotated per org), so no symmetric contraction applies and
    the exact checker must enumerate."""
    sizes = [3 + (i % 3) for i in range(n_orgs)]
    orgs = [[bytes([o + 1]) * 31 + bytes([v]) for v in range(sz)]
            for o, sz in enumerate(sizes)]

    def inner(o):
        return qset(sizes[o] // 2 + 1, orgs[o])

    qmap = {}
    thr = (2 * n_orgs + 2) // 3
    for o in range(n_orgs):
        q = qset(thr, inner=[inner((o + j) % n_orgs) for j in range(n_orgs)])
        for m in orgs[o]:
            qmap[m] = q
    return qmap


def tier1_quorum_map(n_orgs: int = 9):
    """bench.py config #3: orgs x 3 validators, inner sets 2-of-3, top
    threshold 2/3 of the orgs (the pubnet tier-1 shape)."""
    per_org = 3
    ids = [bytes([o + 1]) * 31 + bytes([v]) for o in range(n_orgs)
           for v in range(per_org)]
    inner = [qset(2, ids[o * per_org:(o + 1) * per_org])
             for o in range(n_orgs)]
    q = qset((2 * n_orgs + 2) // 3, inner=inner)
    return {v: q for v in ids}


def adversarial_quorum_map(n: int = 16):
    """bench.py config #5's rings16: n nodes, each requiring 4 of itself
    and its next 5 ring neighbours."""
    ids = [bytes([i + 1]) * 32 for i in range(n)]
    return {ids[i]: qset(4, [ids[(i + d) % n] for d in range(6)])
            for i in range(n)}
