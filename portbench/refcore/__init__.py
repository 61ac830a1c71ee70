"""The benchmark's reference: a plain close of the traffic's ledgers
(createAccount and native payment transactions, tx-set-size upgrades),
the bucket list and header hash chain they feed, and the history archive
a publisher writes from them.  It descends from the host modules of
``stellar_core_tpu_torch`` as they stood when the benchmark was written,
cut to those paths, and is frozen here: a change to the port moves
neither the inputs nor the reference.  It imports nothing of the port and
no ``torch``.
"""
