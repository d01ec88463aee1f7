"""Host syncs per ``sim`` call, as ``torch.cuda.set_sync_debug_mode("warn")``
reports them inside the call (the harness's own sync after it not counted):
the peel's two host reads a sweep, and the rest of the step's."""

UNIT = "count"


def read(run):
    return run.syncs_per_call if run.layer == "sim" else None
