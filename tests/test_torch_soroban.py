"""The port's Soroban layer against the reference's, byte for byte.

* The reference's own tests of tests/test_soroban.py run on both packages
  (test_torch_mirror): invocations and their budgets, footprint errors,
  TTL archival and eviction, extend-TTL and restore operations, the
  footprint clusters; every close's hash and result set must be the
  reference's.
* ``soroban_ledgers``: one scenario, written as a function of the package
  root, invokes every built-in host function, in and out of its
  footprint, over a few ledgers mixed with classic payments, then
  extends and restores; the records (hashes, result sets, entries)
  must be equal.
* ``tx_sets``: ``build_generalized_tx_set`` (with and without phase base
  fees), ``make_tx_set_any``, ``decode_tx_set`` of both shapes and the
  phase helpers on the same frames.

``soroban.config`` holds process-global network settings; each test
starts and ends with the default settings on both packages.
"""

import importlib

import pytest

from test_torch_mirror import ROOTS, assert_mirrored, cases


def _m(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def default_network_config():
    for root in ROOTS:
        cfg = _m(root, "soroban.config")
        cfg.set_network_config(cfg.SorobanNetworkConfig())
    yield
    for root in ROOTS:
        cfg = _m(root, "soroban.config")
        cfg.set_network_config(cfg.SorobanNetworkConfig())


def _setup(root, name):
    X = _m(root, "xdr")
    tu = _m(root, "testutils")
    LM = _m(root, "ledger.manager").LedgerManager
    mgr = LM(tu.network_id(name))
    mgr.start_new_ledger()
    rsk = mgr.root_account_secret()
    e = mgr.root.get_entry(X.account_key_xdr(rsk.public_key.ed25519))
    return X, tu, mgr, tu.TestAccount(mgr, rsk, e.data.value.seqNum)


def _invoke(X, tu, acct, contract, fname, args, rw=(), ro=(),
            instructions=1_000_000):
    sd = tu.make_soroban_data(read_only=list(ro), read_write=list(rw),
                              instructions=instructions)
    return acct.tx([tu.invoke_op(contract, fname, args)],
                   fee=1000 + sd.resourceFee, soroban_data=sd)


def soroban_ledgers(root):
    X, tu, mgr, top = _setup(root, "torch soroban net")
    S = _m(root, "soroban.storage")
    cfg = _m(root, "soroban.config")
    from dataclasses import replace
    cfg.set_network_config(replace(cfg.network_config(),
                                   min_temp_entry_ttl=4,
                                   min_persistent_entry_ttl=6))
    P, T = X.ContractDataDurability.PERSISTENT, X.ContractDataDurability.TEMPORARY
    c1, c2 = tu.contract_address(1), tu.contract_address(2)
    k = X.SCVal.sym("k")
    dk_p = S.contract_data_key(c1, k, P)
    dk_t = S.contract_data_key(c2, k, T)
    rec = []

    def close(*frames):
        ct = int(mgr.lcl_header.scpValue.closeTime) + 5
        arts = mgr.close_ledger(list(frames), ct)
        rec.append((mgr.lcl_hash, arts.result_entry.txResultSet.to_xdr()))
        for key in (dk_p, dk_t, S.ttl_key(dk_p), S.ttl_key(dk_t)):
            e = mgr.root.get_entry(key.to_xdr())
            rec.append(None if e is None else e.to_xdr())

    # a second account, for the classic payments that share ledgers with
    # the invocations (one source's transactions apply in sequence order,
    # the classic phase before the Soroban phase)
    SK = _m(root, "crypto.keys").SecretKey
    sk = SK(b"\x33" * 32)
    close(top.tx([tu.create_account_op(
        X.AccountID.ed25519(sk.public_key.ed25519), 10 ** 10)]))
    payer = tu.TestAccount(mgr, sk, mgr.root.get_entry(X.account_key_xdr(
        sk.public_key.ed25519)).data.value.seqNum)
    close(_invoke(X, tu, top, c1, "put",
                  [k, X.SCVal.u64(7), X.SCVal.sym("persistent")], rw=[dk_p]))
    close(_invoke(X, tu, top, c2, "put",
                  [k, X.SCVal.u64(9), X.SCVal.sym("temporary")], rw=[dk_t]),
          payer.tx([tu.native_payment_op(top.account_id, 5)]))
    close(_invoke(X, tu, top, c1, "get", [k, X.SCVal.sym("persistent")],
                  ro=[dk_p]))
    for fname, args in (("add", [X.SCVal.u64(2), X.SCVal.u64(40)]),
                        ("mul", [X.SCVal.u64(6), X.SCVal.u64(7)]),
                        ("sha256", [X.SCVal.bytes(b"torch")]),
                        ("emit", [X.SCVal.sym("topic"), X.SCVal.u64(1)]),
                        ("fail", []),
                        ("burn", [X.SCVal.u64(10 ** 9)])):
        close(_invoke(X, tu, top, c1, fname, args))
    # out of footprint: a write to a key declared read-only, and none
    close(_invoke(X, tu, top, c1, "put",
                  [k, X.SCVal.u64(1), X.SCVal.sym("persistent")], ro=[dk_p]))
    close(_invoke(X, tu, top, c1, "put",
                  [k, X.SCVal.u64(1), X.SCVal.sym("persistent")]))
    close(_invoke(X, tu, top, c1, "has", [k, X.SCVal.sym("persistent")],
                  ro=[dk_p]),
          _invoke(X, tu, top, c2, "del", [k, X.SCVal.sym("temporary")],
                  rw=[dk_t]))
    # let the persistent entry archive, then extend (fails) and restore
    for _ in range(8):
        close()
    ext = tu.make_soroban_data(read_only=[dk_p])
    close(top.tx([tu.extend_ttl_op(20)], fee=1000 + ext.resourceFee,
                 soroban_data=ext))
    rst = tu.make_soroban_data(read_write=[dk_p])
    close(top.tx([tu.restore_footprint_op()], fee=1000 + rst.resourceFee,
                 soroban_data=rst))
    close(top.tx([tu.extend_ttl_op(30)], fee=1000 + ext.resourceFee,
                 soroban_data=ext))
    rec.append(mgr.bucket_list.hash())
    return rec


def tx_sets(root):
    X, tu, mgr, top = _setup(root, "torch txset net")
    TS = _m(root, "soroban.txset")
    SC = _m(root, "soroban.scheduler")
    S = _m(root, "soroban.storage")
    P = X.ContractDataDurability.PERSISTENT
    classic = [top.tx([tu.native_payment_op(top.account_id, 1 + i)])
               for i in range(3)]
    soroban = []
    for i in range(4):
        c = tu.contract_address(10 + i % 2)
        dk = S.contract_data_key(c, X.SCVal.u64(i), P)
        soroban.append(_invoke(X, tu, top, c, "put",
                               [X.SCVal.u64(i), X.SCVal.u64(i),
                                X.SCVal.sym("persistent")], rw=[dk]))
    rec = []
    for fees in ((None, None), (100, 250)):
        gts, h = TS.build_generalized_tx_set(mgr.lcl_hash, classic, soroban,
                                             *fees)
        blob = gts.to_xdr()
        back = TS.decode_tx_set(blob)
        rec.append((blob, h, TS.is_generalized(back),
                    [[e.to_xdr() for e in ph] for ph in TS.tx_set_phases(back)],
                    TS.phase_base_fees(back), TS.tx_set_previous_hash(back),
                    [e.to_xdr() for e in TS.tx_set_envelopes(back)]))
    legacy, h, ordered = mgr.make_tx_set(classic)
    back = TS.decode_tx_set(legacy.to_xdr())
    rec.append((legacy.to_xdr(), h, TS.is_generalized(back),
                [f.content_hash() for f in ordered]))
    gts, h, ordered = mgr.make_tx_set_any(classic + soroban)
    rec.append((gts.to_xdr(), h, [f.content_hash() for f in ordered]))
    rec.append([TS.is_soroban_frame(f) for f in classic + soroban])
    rec.append([sorted(len(x) for x in SC.tx_rw_keys(f)) for f in soroban])
    rec.append([[f.content_hash() for f in cl]
                for cl in SC.cluster_footprints(soroban)])
    arts = mgr.close_ledger(classic + soroban, 1000)
    rec.append((mgr.lcl_hash, arts.result_entry.txResultSet.to_xdr(),
                arts.tx_entry.to_xdr()))
    return rec


@pytest.mark.parametrize("scenario", [soroban_ledgers, tx_sets],
                         ids=["host_functions_ttl_restore", "tx_sets"])
def test_soroban_scenario_on_both_packages(scenario):
    ref = scenario(ROOTS[0])
    port = scenario(ROOTS[1])
    assert len(ref) > 5
    assert port == ref


@pytest.mark.parametrize("case", cases("test_soroban.py"))
def test_reference_soroban_tests_on_both_packages(case):
    assert_mirrored("test_soroban.py", case)
