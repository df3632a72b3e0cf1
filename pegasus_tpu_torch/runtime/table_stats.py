"""Per-table (tenant) resource ledger.

Port of pegasus_tpu/runtime/table_stats.py, with its counter names and
snapshot keys, so a fold takes fragments of both packages. One
`TableLedger` per (process, table) charges serving-path work (ops and
latency per op class, bytes in/out, errors, throttle delay-ms) into
`table.<name>.*` counters, and folds device-plane attribution
(compaction seconds and offload bytes from the job tracer's compact
jobs, device-read probe counts, device-resident bytes) onto the same
key.

Ledgers live in the process-wide `TABLE_STATS` registry. Replica hosts
register each opened replica's gpid under its table name, so signals
that only know an (app_id, pidx) (the job tracer's compact jobs,
transport-level dispatch rejects) can still be charged to the right
tenant. `snapshot()` exports one JSON-able dict per table (totals, not
windowed rates: windowed values do not survive a remote fold), and
`fold_snapshots()` is the one shared merge used by the meta, the shell
and the beacon: totals sum, percentiles MAX.

Counters are resolved once per ledger: the registry lock is per call,
and hot-path lookups would convoy concurrent readers.
"""

import threading

from .perf_counters import counters

# snapshot keys that are percentile dicts (MAX-merged on fold); every
# other numeric key sums
_PCTL_KEYS = ("read_latency_us", "write_latency_us", "scan_latency_us")
_SUM_KEYS = ("read_qps", "write_qps", "scan_qps", "bytes_in", "bytes_out",
             "errors", "throttle_delay_ms", "device_seconds",
             "offload_bytes", "device_read_count", "hbm_resident_bytes")


class TableLedger:
    """One table's per-process accounting; all charge_* methods are
    lock-free (each hits its own pre-resolved counter)."""

    def __init__(self, name: str):
        self.name = name
        pfx = f"table.{name}."
        self._c_read_qps = counters.rate(pfx + "read_qps")
        self._c_write_qps = counters.rate(pfx + "write_qps")
        self._c_scan_qps = counters.rate(pfx + "scan_qps")
        self._c_bytes_in = counters.rate(pfx + "bytes_in")
        self._c_bytes_out = counters.rate(pfx + "bytes_out")
        self._c_errors = counters.rate(pfx + "error_count")
        # incremented BY delay-ms so .total() is the monotone ms sum
        self._c_throttle_ms = counters.rate(pfx + "throttle_delay_ms")
        self._c_read_lat = counters.percentile(pfx + "read_latency_us")
        self._c_write_lat = counters.percentile(pfx + "write_latency_us")
        self._c_scan_lat = counters.percentile(pfx + "scan_latency_us")
        # device-plane attribution: window-scoped gauges refreshed by the
        # beacon path (attribute_jobs / set_hbm_resident), plus a monotone
        # probe count charged at the engine's device-lookup site
        self._c_device_s = counters.number(pfx + "device_seconds")
        self._c_offload_b = counters.number(pfx + "offload_bytes")
        self._c_device_reads = counters.number(pfx + "device_read_count")
        self._c_hbm = counters.number(pfx + "hbm_resident_bytes")

    # ------------------------------------------------------- serving path

    def charge_read(self, elapsed_us: int, nbytes_out: int = 0) -> None:
        self._c_read_qps.increment()
        self._c_read_lat.set(elapsed_us)
        if nbytes_out:
            self._c_bytes_out.increment(nbytes_out)

    def charge_write(self, elapsed_us: int, nbytes_in: int = 0,
                     n_ops: int = 1) -> None:
        self._c_write_qps.increment(n_ops)
        self._c_write_lat.set(elapsed_us)
        if nbytes_in:
            self._c_bytes_in.increment(nbytes_in)

    def charge_scan(self, elapsed_us: int, nbytes_out: int = 0) -> None:
        self._c_scan_qps.increment()
        self._c_scan_lat.set(elapsed_us)
        if nbytes_out:
            self._c_bytes_out.increment(nbytes_out)

    def charge_bytes_in(self, nbytes: int) -> None:
        self._c_bytes_in.increment(nbytes)

    def charge_error(self, n: int = 1) -> None:
        self._c_errors.increment(n)

    def charge_throttle_delay(self, delay_ms: float) -> None:
        self._c_throttle_ms.increment(delay_ms)

    # ------------------------------------------------------- device plane

    def charge_device_read(self, n_probes: int = 1) -> None:
        self._c_device_reads.increment(n_probes)

    def set_hbm_resident(self, nbytes: int) -> None:
        self._c_hbm.set(nbytes)

    def set_device_attribution(self, device_seconds: float,
                               offload_bytes: int) -> None:
        self._c_device_s.set(device_seconds)
        self._c_offload_b.set(offload_bytes)

    # ----------------------------------------------------------- export

    def snapshot(self) -> dict:
        return {
            "read_qps": self._c_read_qps.total(),
            "write_qps": self._c_write_qps.total(),
            "scan_qps": self._c_scan_qps.total(),
            "bytes_in": self._c_bytes_in.total(),
            "bytes_out": self._c_bytes_out.total(),
            "errors": self._c_errors.total(),
            "throttle_delay_ms": self._c_throttle_ms.total(),
            "device_seconds": self._c_device_s.value(),
            "offload_bytes": self._c_offload_b.value(),
            "device_read_count": self._c_device_reads.value(),
            "hbm_resident_bytes": self._c_hbm.value(),
            "read_latency_us": self._c_read_lat.percentiles(),
            "write_latency_us": self._c_write_lat.percentiles(),
            "scan_latency_us": self._c_scan_lat.percentiles(),
        }

    def unregister(self) -> None:
        pfx = f"table.{self.name}."
        for suffix in _SUM_KEYS + _PCTL_KEYS:
            name = {"errors": "error_count"}.get(suffix, suffix)
            counters.remove(pfx + name)


class TableStats:
    """Process-wide registry: table name -> TableLedger, plus the
    gpid -> table mapping that lets partition- and job-scoped signals
    land on a tenant key."""

    def __init__(self):
        self._lock = threading.Lock()  # lockrank: leaf (no calls out)
        self._ledgers = {}      #: guarded_by self._lock
        self._by_app = {}       # app_id -> table  #: guarded_by self._lock
        self._by_gpid = {}      # "app.pidx" -> table  #: guarded_by self._lock

    def ledger(self, name: str) -> TableLedger:
        with self._lock:
            led = self._ledgers.get(name)
            if led is None:
                led = self._ledgers[name] = TableLedger(name)
            return led

    def register_gpid(self, app_id: int, pidx: int, table: str) -> TableLedger:
        led = self.ledger(table)
        with self._lock:
            self._by_app[app_id] = table
            self._by_gpid[f"{app_id}.{pidx}"] = table
        return led

    def table_for_app(self, app_id: int) -> str:
        with self._lock:
            return self._by_app.get(app_id, "")

    def table_for_gpid(self, gpid: str) -> str:
        with self._lock:
            return self._by_gpid.get(gpid, "")

    def charge_app_error(self, app_id: int) -> None:
        """Charge a transport-level reject (e.g. an armed serve.dispatch
        fail point) to the table serving app_id; no-op when unmapped —
        meta/collector traffic carries app_id 0."""
        with self._lock:
            name = self._by_app.get(app_id)
            led = self._ledgers.get(name) if name else None
        if led is not None:
            led.charge_error()

    # ------------------------------------------------- device attribution

    def attribute_jobs(self, jobs) -> None:
        """Fold completed causal jobs (job tracer dicts) into
        per-table device seconds + offload bytes. Compact jobs carry a
        pidx attr and hop records whose `offload.ship`/`offload.fetch`
        nbytes are the offload wire cost; the gpid -> table map resolves
        the tenant. Window-scoped gauge semantics: each call REPLACES
        the attribution (callers pass the tracer's retained window)."""
        device_s = {}
        offload_b = {}
        for job in jobs:
            if job.get("kind") != "compact" or "status" not in job:
                continue
            attrs = job.get("attrs", {})
            gpid = attrs.get("gpid", "")
            if not gpid:
                pidx = attrs.get("pidx")
                if pidx is None:
                    continue
                with self._lock:
                    hits = [t for g, t in self._by_gpid.items()
                            if g.endswith(f".{pidx}")]
                # ambiguous pidx (several tables share it): skip rather
                # than mis-charge
                if len(set(hits)) != 1:
                    continue
                table = hits[0]
            else:
                table = self.table_for_gpid(gpid)
            if not table:
                continue
            device_s[table] = (device_s.get(table, 0.0)
                               + job.get("duration_us", 0) / 1e6)
            for hop in job.get("hops", []):
                if hop.get("name", "").startswith("offload."):
                    offload_b[table] = (offload_b.get(table, 0)
                                        + int(hop.get("nbytes", 0)))
        with self._lock:
            leds = list(self._ledgers.values())
        for led in leds:
            led.set_device_attribution(device_s.get(led.name, 0.0),
                                       offload_b.get(led.name, 0))

    # ----------------------------------------------------------- export

    def snapshot(self) -> dict:
        with self._lock:
            leds = list(self._ledgers.values())
        return {led.name: led.snapshot() for led in leds}

    def tables(self) -> list:
        with self._lock:
            return sorted(self._ledgers)

    def reset(self) -> None:
        """Test hook: drop every ledger AND its registry counters."""
        with self._lock:
            leds = list(self._ledgers.values())
            self._ledgers.clear()
            self._by_app.clear()
            self._by_gpid.clear()
        for led in leds:
            led.unregister()


def fold_snapshots(fragments) -> dict:
    """Merge per-process snapshot() dicts (e.g. pid-keyed remote-command
    fragments) into one per-table view: totals sum across processes,
    latency percentile dicts take the per-quantile MAX (worst host)."""
    out = {}
    for frag in fragments:
        if not isinstance(frag, dict):
            continue
        for table, m in frag.items():
            if not isinstance(m, dict):
                continue
            agg = out.setdefault(table, {})
            for k, v in m.items():
                if k in _PCTL_KEYS and isinstance(v, dict):
                    cur = agg.setdefault(k, {})
                    for q, qv in v.items():
                        cur[q] = max(cur.get(q, 0), qv)
                elif isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
    return out


def top_k(folded: dict, k: int = 5) -> dict:
    """Capacity attribution: rank tables by each resource axis."""
    axes = {
        "ops": lambda m: (m.get("read_qps", 0) + m.get("write_qps", 0)
                          + m.get("scan_qps", 0)),
        "bytes": lambda m: m.get("bytes_in", 0) + m.get("bytes_out", 0),
        "device_seconds": lambda m: m.get("device_seconds", 0),
        "hbm_bytes": lambda m: m.get("hbm_resident_bytes", 0),
    }
    out = {}
    for axis, keyfn in axes.items():
        ranked = sorted(((keyfn(m), t) for t, m in folded.items()),
                        reverse=True)
        out[axis] = [{"table": t, "value": v} for v, t in ranked[:k] if v > 0]
    return out


TABLE_STATS = TableStats()
