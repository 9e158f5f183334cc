"""Per-query memory high-water sampling for the observability stream: the
port of nds_tpu/obs/memwatch.py.

Preferred source: the CUDA caching allocator's bytes allocated now
(`torch.cuda.memory_stats(i)["allocated_bytes.all.current"]`) for each
visible device, read only in a process whose CUDA is already initialised,
so a sampler never creates a CUDA context: a spawn worker that has not
touched the card (a lakehouse Load Test worker, a process-mode throughput
child before its session exists) stays off it. Fallback: process RSS from
/proc/self/statm (a CPU session allocates its intermediates in host
memory, so RSS is the honest proxy there; it is also the signal the
host-RSS watermark watches).

The sampler is a daemon thread started only while a traced query runs
(BenchReport gates it on the session tracer), so with tracing off it costs
nothing. Interval knob: NDS_TRACE_MEM_INTERVAL_MS (default 50).

Heartbeats: because this thread is the one part of a query that keeps
running while the query itself may be wedged, it doubles as the liveness
beacon: with a tracer attached it emits a `heartbeat` event (query,
elapsed_ms, rss_bytes) every NDS_HEARTBEAT_INTERVAL_MS (default 1000),
so a hang is visible live (/statusz heartbeat age keeps ticking while
in-flight elapsed grows) and classifiable post-hoc from the log tail.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def device_bytes_per_device():
    """Per-device bytes allocated by torch's CUDA caching allocator, as a
    list (index = device ordinal), or None on a host without CUDA and in a
    process whose CUDA is not initialised: torch is not imported here, and
    the allocator is read only where a context already exists. Kept PER
    DEVICE on purpose: the /statusz `mesh` section and failure bundles
    want the straggler device visible, not one aggregated max."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        out = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out.append(int(stats.get("allocated_bytes.all.current", 0)))
        return out or None
    except Exception:
        return None


def device_bytes_in_use():
    """Total bytes allocated over the visible CUDA devices, or None where
    `device_bytes_per_device` reads none."""
    per = device_bytes_per_device()
    return sum(per) if per is not None else None


def rss_bytes():
    """Resident set size from /proc/self/statm, or None off-Linux."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return None


class MemorySampler:
    """Background high-water sampler: max over periodic samples of the best
    available memory signal. Use as a context manager; read `.peak_bytes`
    (int | None) and `.source` ("device" | "rss" | None) after exit.

    Host-OOM pre-emption: with `watermark_bytes` set, the sampler fires
    `on_watermark(sample_bytes)` ONCE from its thread the first time the
    process RSS crosses the watermark — the ladder-before-the-allocator
    hook report.py uses to shrink the blocked-union window mid-query
    (ROADMAP carry-forward: pre-empt via RSS watermarks before the
    allocator fails). The watermark always watches RSS, independent of
    which signal feeds `peak_bytes`: host allocation death is a host-side
    phenomenon even when device stats are the better high-water source."""

    def __init__(self, interval_s: float | None = None,
                 watermark_bytes: int | None = None, on_watermark=None,
                 tracer=None, query=None, heartbeat_s: float | None = None,
                 on_heartbeat=None):
        if interval_s is None:
            interval_s = (
                float(os.environ.get("NDS_TRACE_MEM_INTERVAL_MS", "50")) / 1000
            )
        self.interval_s = max(interval_s, 0.001)
        # single-writer discipline instead of a lock: every field below
        # is mutated only by the sampler thread (_sample) or by the
        # owner before start / after join (__enter__/__exit__), and the
        # owner reads peaks only after __exit__'s join
        self.peak_bytes = None  # nds-guarded-by: none
        #: per-device high-water (list, device-source runs only): the
        #: straggler-visible half of the peak — query_span carries it as
        #: `mem_hw_per_device` and /statusz's mesh section max-merges it
        self.peak_per_device = None  # nds-guarded-by: none
        self.source = None
        self.watermark_bytes = watermark_bytes or None
        self.on_watermark = on_watermark
        self.watermark_fired = False  # nds-guarded-by: none
        # heartbeat beacon (module docstring): emitted through `tracer`
        # (passed explicitly — thread-locals don't reach this thread)
        # at most every `heartbeat_s`; tracer None disables it
        self.tracer = tracer
        self.query = query
        # per-beat liveness work beyond the beacon (e.g. report.py renews
        # the session's lakehouse reader leases here, so a statement
        # outliving the lease TTL keeps its snapshot vacuum-safe); runs
        # on the sampler thread even when no tracer is attached
        self.on_heartbeat = on_heartbeat
        if heartbeat_s is None:
            heartbeat_s = (
                float(os.environ.get("NDS_HEARTBEAT_INTERVAL_MS", "1000"))
                / 1000
            )
        self.heartbeat_s = max(heartbeat_s, 0.0)
        self._last_hb = None  # nds-guarded-by: none
        self._t0 = None  # nds-guarded-by: none
        self._stop = threading.Event()
        self._thread = None
        # probe once up front so source selection is stable for the run
        if device_bytes_in_use() is not None:
            self._read, self.source = device_bytes_in_use, "device"
        elif rss_bytes() is not None:
            self._read, self.source = rss_bytes, "rss"
        else:
            self._read = None

    def _sample(self):
        per_dev = None
        if self.source == "device":
            per_dev = device_bytes_per_device()
            v = sum(per_dev) if per_dev is not None else None
            if per_dev is not None:
                if self.peak_per_device is None:
                    self.peak_per_device = list(per_dev)
                else:
                    for i, b in enumerate(per_dev):
                        if i < len(self.peak_per_device):
                            if b > self.peak_per_device[i]:
                                self.peak_per_device[i] = b
                        else:
                            self.peak_per_device.append(b)
        else:
            v = self._read() if self._read is not None else None
        if v is not None and (self.peak_bytes is None or v > self.peak_bytes):
            self.peak_bytes = v
        if (
            self.watermark_bytes
            and not self.watermark_fired
            and self.on_watermark is not None
        ):
            r = v if self.source == "rss" else rss_bytes()
            if r is not None and r >= self.watermark_bytes:
                self.watermark_fired = True
                try:
                    self.on_watermark(r)
                except Exception:
                    pass  # pre-emption must never take the query down
        if (
            self.heartbeat_s
            and (self.tracer is not None or self.on_heartbeat is not None)
        ):
            now = time.monotonic()
            if self._last_hb is None or now - self._last_hb >= self.heartbeat_s:
                self._last_hb = now
                if self.on_heartbeat is not None:
                    try:
                        self.on_heartbeat()
                    except Exception:
                        pass  # beat work must never take the query down
                if self.tracer is None:
                    return
                r = v if self.source == "rss" else rss_bytes()
                try:
                    self.tracer.emit(
                        "heartbeat",
                        query=self.query,
                        elapsed_ms=round((now - self._t0) * 1000, 1),
                        rss_bytes=r,
                        # per-device HBM rides the beacon so the live
                        # /statusz mesh section tracks each device's
                        # high-water, not one aggregated max
                        **({"dev_bytes": list(per_dev)}
                           if per_dev is not None else {}),
                    )
                except Exception:
                    pass  # the beacon must never take the query down

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._sample()

    def __enter__(self):
        self._t0 = time.monotonic()
        # the thread also runs with no readable memory signal when a
        # tracer wants heartbeats (or beat work is registered): the
        # beacon is about liveness, not bytes
        if (
            self._read is not None
            or self.tracer is not None
            or self.on_heartbeat is not None
        ):
            self._sample()
            self._thread = threading.Thread(
                target=self._loop, name="nds-obs-memwatch", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._sample()  # final reading: catch an end-of-query peak
        return False
