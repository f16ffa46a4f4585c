"""Host seconds of ``auto_qr`` at set-up: the structure analysis, the
solver's choice and its first factorization.  The kernels' libraries are
built (on a checkout's first run) and loaded before this span."""


def read(ctx):
    return getattr(ctx.caller, "spans", {}).get("analysis_s")
