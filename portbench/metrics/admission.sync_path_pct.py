"""admission.sync_path_pct: the share of submissions admitted on the
synchronous CPU path before the reply (AdmissionPipeline.stats sync_path
over submitted, window deltas)."""


def read(ctx):
    submitted = ctx.stats.get("admission_submitted", 0)
    if submitted <= 0:
        return None
    return 100.0 * ctx.stats.get("admission_sync_path", 0) / submitted
