"""The three Soroban operation frames.

Reference: src/transactions/InvokeHostFunctionOpFrame.cpp,
ExtendFootprintTTLOpFrame.cpp, RestoreFootprintOpFrame.cpp.  All three
run at LOW threshold and require protocol 20+ plus a Soroban tx
(exactly one op, SorobanTransactionData present — enforced at the
transaction level, see transactions/frame.py).

Failure discipline: every host failure maps to the op's structured
result code and the per-op LedgerTxn rolls back — fee charged, state
untouched, node unharmed.  Only genuine infrastructure bugs escape as
exceptions (and those fail-stop the node by design).
"""

from __future__ import annotations

from .. import xdr as X
from ..transactions.operations import (OperationFrame, register_op_class,
                                       THRESHOLD_LOW)
from ..util.metrics import registry as _registry
from .config import network_config
from .host import Budget, HostError, invoke_host_function, result_hash
from .storage import FootprintStorage, ttl_key_for_xdr, make_ttl_entry

OT = X.OperationType
IHC = X.InvokeHostFunctionResultCode
EXC = X.ExtendFootprintTTLResultCode
RSC = X.RestoreFootprintResultCode

SOROBAN_PROTOCOL_VERSION = 20

_DATA_KEY_TYPES = (X.LedgerEntryType.CONTRACT_DATA,
                   X.LedgerEntryType.CONTRACT_CODE)


class _SorobanOpFrame(OperationFrame):
    MIN_PROTOCOL_VERSION = SOROBAN_PROTOCOL_VERSION

    def threshold_level(self) -> int:
        return THRESHOLD_LOW

    def _soroban_data(self):
        return self.tx.soroban_data()


class InvokeHostFunctionOpFrame(_SorobanOpFrame):
    OP_TYPE = OT.INVOKE_HOST_FUNCTION
    RESULT_CLS = X.InvokeHostFunctionResult

    def do_check_valid(self, ltx):
        if self.body.hostFunction.switch != \
                X.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT:
            # upload/create need the wasm host; the bounded host only
            # dispatches invoke-contract (PARITY.md Soroban rows)
            return self.result(IHC.INVOKE_HOST_FUNCTION_MALFORMED)
        return self.success(b"\x00" * 32)

    def do_apply(self, ltx):
        sd = self._soroban_data()
        net = network_config()
        resources = sd.resources
        budget = Budget(
            cpu_limit=min(int(resources.instructions),
                          net.tx_max_instructions),
            mem_limit=net.tx_max_memory_bytes)
        invoke_args = self.body.hostFunction.value
        storage = FootprintStorage(
            ltx, invoke_args.contractAddress, resources, net, budget,
            ledger_seq=ltx.get_header().ledgerSeq)
        reg = _registry()
        try:
            with reg.timer("soroban.host.invoke").time():
                ret, events, _host = invoke_host_function(
                    invoke_args, storage, budget)
        except HostError as e:
            if e.code == IHC.INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED:
                reg.meter("soroban.host.budget-exceeded").mark()
            else:
                reg.meter("soroban.host.trap").mark()
            return self.result(e.code)
        reg.histogram("soroban.host.cpu-insns").update(budget.cpu_used)
        return self.success(result_hash(ret, events))


class ExtendFootprintTTLOpFrame(_SorobanOpFrame):
    OP_TYPE = OT.EXTEND_FOOTPRINT_TTL
    RESULT_CLS = X.ExtendFootprintTTLResult

    def do_check_valid(self, ltx):
        sd = self._soroban_data()
        fp = sd.resources.footprint
        if fp.readWrite or not fp.readOnly:
            # reference: extended keys ride in readOnly ONLY (the op
            # mutates TTL entries, never the data entries themselves)
            return self.result(EXC.EXTEND_FOOTPRINT_TTL_MALFORMED)
        if int(self.body.extendTo) > network_config().max_entry_ttl:
            return self.result(EXC.EXTEND_FOOTPRINT_TTL_MALFORMED)
        if any(k.switch not in _DATA_KEY_TYPES for k in fp.readOnly):
            return self.result(EXC.EXTEND_FOOTPRINT_TTL_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        sd = self._soroban_data()
        seq = int(ltx.get_header().ledgerSeq)
        extend_to = int(self.body.extendTo)
        read_bytes = 0
        for key in sorted(sd.resources.footprint.readOnly,
                          key=lambda k: k.to_xdr()):
            key_xdr = key.to_xdr()
            entry = ltx.load_by_bytes(key_xdr)
            if entry is None:
                continue
            read_bytes += len(entry.to_xdr())
            if read_bytes > int(sd.resources.readBytes):
                return self.result(
                    EXC.EXTEND_FOOTPRINT_TTL_RESOURCE_LIMIT_EXCEEDED)
            tk = ttl_key_for_xdr(key_xdr)
            ttl_entry = ltx.load(tk)
            if ttl_entry is None:
                continue
            live_until = int(ttl_entry.data.value.liveUntilLedgerSeq)
            if live_until < seq:
                continue                   # expired: restore, not extend
            new_live = min(seq + extend_to,
                           seq + network_config().max_entry_ttl)
            if new_live > live_until:
                ltx.put(make_ttl_entry(key_xdr, new_live,
                                       last_modified=seq))
        _registry().meter("soroban.ttl.extend").mark()
        return self.success()


class RestoreFootprintOpFrame(_SorobanOpFrame):
    OP_TYPE = OT.RESTORE_FOOTPRINT
    RESULT_CLS = X.RestoreFootprintResult

    def do_check_valid(self, ltx):
        sd = self._soroban_data()
        fp = sd.resources.footprint
        if fp.readOnly or not fp.readWrite:
            # reference: restored keys ride in readWrite ONLY
            return self.result(RSC.RESTORE_FOOTPRINT_MALFORMED)
        if any(k.switch not in _DATA_KEY_TYPES for k in fp.readWrite):
            return self.result(RSC.RESTORE_FOOTPRINT_MALFORMED)
        return self.success()

    def do_apply(self, ltx):
        sd = self._soroban_data()
        net = network_config()
        seq = int(ltx.get_header().ledgerSeq)
        write_bytes = 0
        for key in sorted(sd.resources.footprint.readWrite,
                          key=lambda k: k.to_xdr()):
            key_xdr = key.to_xdr()
            entry = ltx.load_by_bytes(key_xdr)
            if entry is None:
                continue                   # fully evicted: nothing left
            if key.switch == X.LedgerEntryType.CONTRACT_DATA and \
                    entry.data.value.durability != \
                    X.ContractDataDurability.PERSISTENT:
                return self.result(RSC.RESTORE_FOOTPRINT_MALFORMED)
            tk = ttl_key_for_xdr(key_xdr)
            ttl_entry = ltx.load(tk)
            live_until = None if ttl_entry is None else \
                int(ttl_entry.data.value.liveUntilLedgerSeq)
            if live_until is not None and live_until >= seq:
                continue                   # still live: nothing to restore
            write_bytes += len(entry.to_xdr())
            if write_bytes > int(sd.resources.writeBytes):
                return self.result(
                    RSC.RESTORE_FOOTPRINT_RESOURCE_LIMIT_EXCEEDED)
            ltx.put(make_ttl_entry(
                key_xdr, seq + net.min_persistent_entry_ttl - 1,
                last_modified=seq))
        _registry().meter("soroban.ttl.restore").mark()
        return self.success()


register_op_class(OT.INVOKE_HOST_FUNCTION, InvokeHostFunctionOpFrame)
register_op_class(OT.EXTEND_FOOTPRINT_TTL, ExtendFootprintTTLOpFrame)
register_op_class(OT.RESTORE_FOOTPRINT, RestoreFootprintOpFrame)
