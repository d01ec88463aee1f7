"""Host syncs per ``hybrid`` call, as ``torch.cuda.set_sync_debug_mode("warn")``
reports them inside the call (the harness's own sync after it not counted)."""

UNIT = "count"


def read(run):
    return run.syncs_per_call if run.layer == "hybrid" else None
