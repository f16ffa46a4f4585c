"""Host milliseconds of the program's own parts a traced fit call: its
host ranges ``qrk.fit.*`` (initial guess, upload, canonical form),
``qrk.loop.copy_in`` and ``qrk.loop.launch``.  ``qrk.loop.fetch`` is
left out: it waits on the device."""
from ..program_trace import host_spans

PARTS = ("qrk.fit.", "qrk.loop.copy_in", "qrk.loop.launch")


def read(ctx):
    spans = [h for part in PARTS for h in host_spans(ctx.trace, part)]
    if not spans or not ctx.traced:
        return None
    return sum(t - s for _, s, t in spans) / 1e3 / len(ctx.traced)
