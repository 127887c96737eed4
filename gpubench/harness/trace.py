"""A ``torch.profiler`` session over a stretch of the window, and what the
metrics read from it.

The benchmark marks its own host spans with ``record_function`` ranges
named ``gpubench.<span>``; ``gpubench.stretch`` encloses the profiled
stretch.  A kernel, copy or fill on the device shares its correlation id
with the runtime call (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...) that queued it, and that call runs on the host, so
the span that holds the call is the span that launched the work, whatever
the device's clock says.  The device-side annotations the profiler adds
under each range's name are left out of the device's work.
"""

from __future__ import annotations

import bisect
import collections
import heapq

from . import stats

PREFIX = "gpubench."
STRETCH = PREFIX + "stretch"

#: one profiler event: ``on_device`` for kernels, copies and fills (and the
#: annotations, which are dropped); ``corr`` the correlation id; times in
#: microseconds on the profiler's clock
Ev = collections.namedtuple("Ev", "name on_device corr start end")


def span(name):
    """A host span of the benchmark, seen by the profiler when it runs."""
    import torch

    return torch.profiler.record_function(PREFIX + name)


class Session:
    """One profiler session (a process holds one: a later one may come back
    empty); ``span("stretch")`` marks the profiled stretch in it."""

    def __init__(self, on_device):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_device:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.open = True

    def stop(self):
        if self.open:
            self.prof.stop()
            self.open = False

    def events(self):
        """The session's events as :data:`Ev` tuples."""
        import torch

        self.stop()
        cpu = torch.autograd.DeviceType.CPU
        return [Ev(e.name, e.device_type != cpu, e.id, e.time_range.start, e.time_range.end)
                for e in self.prof.events()]


class Summary:
    """What a stretch of events says: the device's work in it, which span
    launched each piece, and the gaps."""

    def __init__(self, events):
        stretches = [e for e in events if not e.on_device and e.name == STRETCH]
        if len(stretches) != 1:
            raise ValueError(f"the trace holds {len(stretches)} stretches, not one")
        self.lo, self.hi = stretches[0].start, stretches[0].end
        self.host = [e for e in events if not e.on_device]
        self.device = [e for e in events if e.on_device and not e.name.startswith(PREFIX)
                       and e.end > self.lo and e.start < self.hi]
        self._launches = collections.defaultdict(list)
        self._spans = collections.defaultdict(list)
        for e in self.host:
            if e.name.startswith("cu"):
                self._launches[e.corr].append(e.start)
            elif e.name.startswith(PREFIX) and e.name != STRETCH:
                self._spans[e.name[len(PREFIX):]].append((e.start, e.end))
        for spans in self._spans.values():
            spans.sort()

    @property
    def window_s(self):
        return (self.hi - self.lo) * 1e-6

    def busy_s(self):
        """Seconds of the stretch in which the device ran something."""
        return stats.busy([(e.start, e.end) for e in self.device], self.lo, self.hi) * 1e-6

    def idle_pct(self):
        return stats.idle_share([(e.start, e.end) for e in self.device], self.lo, self.hi)

    def span_count(self, name):
        """Spans called ``name`` that lie wholly in the stretch."""
        return sum(1 for s, e in self._spans.get(name, ()) if s >= self.lo and e <= self.hi)

    def _in_span(self, spans, t):
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def launched_by(self, name):
        """The device work launched from spans called ``name``; raises for
        work whose launching call the trace does not hold."""
        spans = self._spans.get(name, [])
        out = []
        for e in self.device:
            if e.corr not in self._launches:
                raise ValueError(f"device work {e.name} (correlation {e.corr}) has no launch")
            if any(self._in_span(spans, t) for t in self._launches[e.corr]):
                out.append(e)
        return out

    def device_ops(self, limit=10):
        """``[[name, seconds], ...]``: the device work of the stretch by name,
        the longest first."""
        total = collections.Counter()
        for e in self.device:
            total[e.name] += (min(e.end, self.hi) - max(e.start, self.lo)) * 1e-6
        return [[name, s] for name, s in total.most_common(limit)]

    def idle_gaps(self, limit=10):
        """``[[what the host did, seconds], ...]``: the stretch's idle time
        on the device by the innermost host event that covers each gap's
        middle ("no host event" where none does), the longest first."""
        total = collections.Counter()
        count = collections.Counter()
        host = sorted((e.start, e.end, e.name) for e in self.host if e.name != STRETCH)
        active, i = [], 0  # a heap of (end, start, name) of the events begun by `mid`
        for start, end in stats.gaps([(e.start, e.end) for e in self.device], self.lo, self.hi):
            mid = (start + end) / 2
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(active, (host[i][1], host[i][0], host[i][2]))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            what = min(active, key=lambda a: a[0] - a[1])[2] if active else "no host event"
            total[what] += (end - start) * 1e-6
            count[what] += 1
        return [[f"{what} ({count[what]} gaps)", s] for what, s in total.most_common(limit)]
