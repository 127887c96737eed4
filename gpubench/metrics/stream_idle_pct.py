"""device under the stream: the share, in percent, of the profiled stretch
of a ``StreamingInverter`` run in which no kernel, copy or fill ran on the
card; the reading of ``idle_pct``, under the stream's own name."""

from gpubench.metrics.idle_pct import read  # noqa: F401
