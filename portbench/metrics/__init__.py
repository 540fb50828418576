"""One reader a metric, ``<metric name>.py``, each with ``read(ctx)``:
the metric's value from the run (``ctx.run``), the cell (``ctx.cell``)
and, in a traced run, the trace (``ctx.trace``); None where the run has
nothing for it to read."""
