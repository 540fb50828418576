"""The surface extraction's least time over its device time: one read
of the volume (``work/surface.py``) at 3.35 TB/s (the card's power limit
is in the result's ``device``), over the device time a scan of the
kernels, copies and memsets launched inside the program's
``export.surface`` span, from the scan that the program traces under the
profiler (``harness/scan_trace.py``, pass (b))."""

from harness import scan_trace
from harness.peaks import bound
from metrics.work import surface


def read(ctx):
    p = scan_trace.passes(ctx)
    ms = None if p is None else p.device_ms.get("export.surface")
    if not ms:
        return None
    least = bound(*surface.volume_work(int(ctx.run.config["volume"]["resolution"]))).seconds
    return 100.0 * least / (ms * 1e-3)
