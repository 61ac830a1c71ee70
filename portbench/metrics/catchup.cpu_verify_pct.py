"""catchup.cpu_verify_pct: the share of the replay's signature checks at
apply that the CPU verified, window deltas.  On the Python path a check is
crypto.verify.recompute (a verify-cache miss, verified on the host: a
group the card had not answered in time under `poll`, or a signature
never paired) or crypto.verify.cache-hit (a verdict the card had seeded);
where the native engine applies, its own cache's misses and hits
(CatchupManager.stats `native_verify_cache_misses` / `_hits`, summed over
the window's passes in the runner's stats) add to them."""


def read(ctx):
    cpu = ctx.counter("crypto.verify.recompute") \
        + ctx.stats.get("native_verify_cache_misses", 0)
    total = cpu + ctx.counter("crypto.verify.cache-hit") \
        + ctx.stats.get("native_verify_cache_hits", 0)
    if total <= 0:
        return None
    return 100.0 * cpu / total
