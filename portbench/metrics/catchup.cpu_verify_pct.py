"""catchup.cpu_verify_pct: the share of the replay's signature checks at
apply that the CPU verified: crypto.verify.recompute (a verify-cache miss,
verified on the host: a group the card had not answered in time under
`poll`, or a signature never paired) over recompute plus
crypto.verify.cache-hit (a verdict the card had seeded), window deltas."""


def read(ctx):
    cpu = ctx.counter("crypto.verify.recompute")
    total = cpu + ctx.counter("crypto.verify.cache-hit")
    if total <= 0:
        return None
    return 100.0 * cpu / total
