"""Geo client: dual-table spatial index over the KV store.

Port of pegasus_tpu/geo/geo_client.py, whole (upstream
src/geo/lib/geo_client.{h,cpp} with the Morton cell scheme of
geo/cells.py in place of S2). Every geo point is written twice,
non-atomically like upstream (geo_client.h:83 'two tables, the update
of which is not atomic'):

  common table: (hash_key, sort_key) -> value           (the user's data)
  geo table:    hash_key = level-L cell token,
                sort_key = full-depth morton hex + 4-hex hash_key length
                           + hash_key + sort_key        (deeper cell path;
                the length field makes parsing exact for keys containing
                any byte value, including NUL)
                -> value

Searches cover the circle with level-L cells, narrow each to Morton
sort-key ranges, scan the ranges concurrently, filter by precise
haversine distance, and sort/limit (upstream's cap covering and parallel
scans, geo_client.cpp:257-330). On a cuda-backend server each range scan
resolves its row interval through the fence-lookup kernel
(engine/server_impl.py _RangeCoalescer -> LsmEngine.scan_range_batch).
"""

import threading
from concurrent.futures import ThreadPoolExecutor

from ..client import PegasusClient
from . import cells
from .latlng_codec import LatlngCodec

_MORTON_HEX = 15  # 60-bit morton code as fixed-width hex


def _split_geo_sort_key(gsk: bytes):
    """-> (hash_key, sort_key) or None when malformed."""
    if len(gsk) < _MORTON_HEX + 4:
        return None
    try:
        hk_len = int(gsk[_MORTON_HEX:_MORTON_HEX + 4], 16)
    except ValueError:
        return None
    body = gsk[_MORTON_HEX + 4:]
    if len(body) < hk_len:
        return None
    return body[:hk_len], body[hk_len:]


class GeoClient:
    def __init__(self, common_client: PegasusClient, geo_client: PegasusClient,
                 min_level: int = 12, max_level: int = 16,
                 codec: LatlngCodec = None, scan_threads: int = 8):
        self.common = common_client
        self.geo = geo_client
        self.min_level = min_level
        # searches narrow each covered cell to level-`max_level` sub-ranges
        # of the Morton sort key (the reference's min_level/max_level pair,
        # geo_client.h:83; S2 16 ~= Morton 16 at city scale)
        self.max_level = max_level
        self.codec = codec or LatlngCodec()
        self.scan_threads = scan_threads
        self._pool = None
        self._pool_lock = threading.Lock()

    def _executor(self):
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    from ..runtime.tasking import tracked_executor

                    self._pool = tracked_executor(
                        self.scan_threads, thread_name_prefix="geo-scan")
        return self._pool

    def close(self) -> None:
        """Shut down the scan pool (the clients are closed by their owner)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- indexing

    def _geo_keys(self, lat: float, lng: float, hash_key: bytes,
                  sort_key: bytes):
        cid = cells.cell_id(lat, lng, self.min_level)
        ghk = cells.cell_token(cid, self.min_level)
        full = b"%015x" % cells.morton(lat, lng)
        if len(hash_key) > 0xFFFF:
            raise ValueError("hash_key too long for the geo index")
        gsk = full + b"%04x" % len(hash_key) + hash_key + sort_key
        return ghk, gsk

    def set(self, hash_key: bytes, sort_key: bytes, value: bytes,
            ttl_seconds: int = 0) -> None:
        """Write data + index (non-atomic pair, like the reference)."""
        latlng = self.codec.decode(value)
        if latlng is None:
            raise ValueError("value carries no decodable lat/lng")
        self.common.set(hash_key, sort_key, value, ttl_seconds)
        ghk, gsk = self._geo_keys(latlng[0], latlng[1], hash_key, sort_key)
        self.geo.set(ghk, gsk, value, ttl_seconds)

    def set_geo_data(self, lat: float, lng: float, hash_key: bytes,
                     sort_key: bytes, value: bytes, ttl_seconds: int = 0):
        """Set with explicit coordinates (patches them into the value)."""
        self.set(hash_key, sort_key,
                 self.codec.encode(value, lat, lng), ttl_seconds)

    def get(self, hash_key: bytes, sort_key: bytes):
        return self.common.get(hash_key, sort_key)

    def delete(self, hash_key: bytes, sort_key: bytes) -> None:
        value = self.common.get(hash_key, sort_key)
        self.common.delete(hash_key, sort_key)
        if value is None:
            return
        latlng = self.codec.decode(value)
        if latlng is not None:
            ghk, gsk = self._geo_keys(latlng[0], latlng[1], hash_key, sort_key)
            self.geo.delete(ghk, gsk)

    # -------------------------------------------------------------- search

    def _scan_one(self, ghk: bytes, start_sk: bytes, stop_sk: bytes,
                  lat: float, lng: float, radius_m: float) -> list:
        out = []
        for _, gsk, value in self.geo.get_scanner(
                ghk, start_sort_key=start_sk, stop_sort_key=stop_sk,
                batch_size=500):
            latlng = self.codec.decode(value)
            if latlng is None:
                continue
            d = cells.haversine_m(lat, lng, latlng[0], latlng[1])
            if d > radius_m:
                continue
            keys = _split_geo_sort_key(gsk)
            if keys is None:
                continue
            out.append((d, keys[0], keys[1], value))
        return out

    def search_radial(self, lat: float, lng: float, radius_m: float,
                      count: int = -1, sort_by_distance: bool = True) -> list:
        """-> [(distance_m, hash_key, sort_key, value)] within the circle.

        Each covered min_level cell is narrowed to the Morton sort-key
        ranges that intersect the circle at max_level (reference
        gen_start/stop_sort_key, geo_client.cpp:433-454), and the range
        scans run concurrently (the reference's parallel cell scans,
        geo_client.cpp:257-330)."""
        tasks = []
        ranges = cells.covering_ranges(lat, lng, radius_m,
                                       self.min_level, self.max_level)
        for cid, spans in sorted(ranges.items()):
            ghk = cells.cell_token(cid, self.min_level)
            if spans is None:
                tasks.append((ghk, b"", b""))
                continue
            for start_m, stop_m in spans:
                stop_sk = (b"" if stop_m >= (1 << 60)
                           else b"%015x" % stop_m)
                tasks.append((ghk, b"%015x" % start_m, stop_sk))
        if len(tasks) > 1 and self.scan_threads > 1:
            chunks = self._executor().map(
                lambda t: self._scan_one(*t, lat, lng, radius_m), tasks)
            out = [r for chunk in chunks for r in chunk]
        else:
            out = [r for t in tasks
                   for r in self._scan_one(*t, lat, lng, radius_m)]
        if sort_by_distance:
            out.sort(key=lambda t: t[0])
        if count > 0:
            out = out[:count]
        return out

    def search_radial_by_key(self, hash_key: bytes, sort_key: bytes,
                             radius_m: float, count: int = -1) -> list:
        value = self.common.get(hash_key, sort_key)
        if value is None:
            return []
        latlng = self.codec.decode(value)
        if latlng is None:
            return []
        return self.search_radial(latlng[0], latlng[1], radius_m, count)

    def distance(self, hk1: bytes, sk1: bytes, hk2: bytes, sk2: bytes):
        """-> meters between two stored points, or None."""
        v1 = self.common.get(hk1, sk1)
        v2 = self.common.get(hk2, sk2)
        if v1 is None or v2 is None:
            return None
        p1, p2 = self.codec.decode(v1), self.codec.decode(v2)
        if p1 is None or p2 is None:
            return None
        return cells.haversine_m(p1[0], p1[1], p2[0], p2[1])
