"""Geo (pegasus_tpu_torch.geo) against pegasus_tpu.geo, in one process.

- The codec and every cells function give the reference's answers on
  seeded inputs: Morton codes, cell ids and tokens at every level,
  haversine distances, cell bounds, circle intersection, the covering
  cells (the MAX_COVERING_CELLS cap included) and the two-level covering
  ranges (the whole-cell paths: max_level <= level, a nearly-full cell,
  and the capped covering's fallback).
- `morton_batch`, the port's numpy form for bulk fills, equals `morton`
  point for point.
- GeoClient over the port's servers (cuda backend on device="cpu") and
  over the reference's (cpu backend) on the same seeded points: equal
  search answers, equal state digests of both tables, equal distances
  and by-key searches, a delete that removes both rows; and every search
  answer equal to a brute force over the known points.

Each package's servers are a GeoBox: two RpcServers, two tables of
four partitions each split across them, clients through StaticResolvers.
Both packages' replica services stamp writes with time.time(): frozen
here, so the value timetags and the digests agree.
"""

import threading

import numpy as np
import pytest

from pegasus_tpu import client as ref_client
from pegasus_tpu.engine import EngineOptions as RefOptions
from pegasus_tpu.engine import replica_service as ref_rs
from pegasus_tpu.engine.replica_service import ReplicaService as RefService
from pegasus_tpu.engine.server_impl import PegasusServer as RefServer
from pegasus_tpu.geo import cells as ref_cells
from pegasus_tpu.geo.geo_client import GeoClient as RefGeo
from pegasus_tpu.geo.latlng_codec import LatlngCodec as RefCodec
from pegasus_tpu.rpc import transport as ref_transport
from pegasus_tpu_torch import client as port_client
from pegasus_tpu_torch.engine import replica_service as port_rs
from pegasus_tpu_torch.engine.db import EngineOptions
from pegasus_tpu_torch.engine.replica_service import ReplicaService
from pegasus_tpu_torch.engine.server_impl import PegasusServer
from pegasus_tpu_torch.geo import GeoClient, LatlngCodec, cells
from pegasus_tpu_torch.rpc import transport as port_transport
from pegasus_tpu_torch.ops.pipeline import stop_pools
from pegasus_tpu_torch.runtime.tasking import TRACKED
from tests.test_torch_replication import _FrozenTime

PARTITIONS = 4
APPS = {"main": 21, "idx": 22}
CENTER = (40.06, 116.40)
BOX = 0.02        # points uniform in CENTER +- BOX degrees
N_POINTS = 1200


def _points(seed: int, n: int = N_POINTS):
    rng = np.random.default_rng(seed)
    return (CENTER[0] + rng.uniform(-BOX, BOX, n),
            CENTER[1] + rng.uniform(-BOX, BOX, n))


# ------------------------------------------------------------ pure functions


def test_codec_equals_the_reference():
    rng = np.random.default_rng(1)
    values = [b"", b"a", b"|||||", b"a|b|c|d|1.5|2.5", b"x||||nan|1",
              b"x||||181|0", b"x||||0|91", b"x||||-180|-90", b"x||||a|b",
              b"x||||1e2|-4.25|tail|more"]
    for lat, lng in zip(rng.uniform(-90, 90, 40), rng.uniform(-180, 180, 40)):
        values.append(b"v|w|x|y|%r|%r" % (float(lng), float(lat)))
    for lat_i, lng_i in ((5, 4), (0, 1), (2, 7)):
        port, ref = LatlngCodec(lat_i, lng_i), RefCodec(lat_i, lng_i)
        for v in values:
            assert port.decode(v) == ref.decode(v), v
            lat, lng = float(rng.uniform(-90, 90)), float(rng.uniform(-180,
                                                                     180))
            assert port.encode(v, lat, lng) == ref.encode(v, lat, lng)


def _seeded_points(seed: int, n: int):
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.uniform(-90, 90, n), [90.0, -90.0, 0.0]])
    lng = np.concatenate([rng.uniform(-180, 180, n), [180.0, -180.0, 0.0]])
    return [(float(a), float(b)) for a, b in zip(lat, lng)]


def _covering_cases():
    """(lat, lng, radius_m, level, max_level): city radii at the geo
    client's levels, polar and antimeridian points, a radius whose
    max_level covering hits MAX_COVERING_CELLS (the whole-cell fallback),
    max_level <= level, and a nearly-full ancestor cell."""
    rng = np.random.default_rng(2)
    cases = [(40.06, 116.4, 15000.0, 12, 16), (31.2304, 121.4737, 800.0,
                                               12, 16),
             (89.9, 10.0, 3000.0, 10, 14), (0.0, 179.99, 2000.0, 11, 15),
             (40.06, 116.4, 500.0, 12, 12), (40.06, 116.4, 500.0, 14, 12),
             (40.06, 116.4, 4000.0, 14, 15), (-33.87, 151.21, 50.0, 16, 20)]
    for _ in range(12):
        cases.append((float(rng.uniform(-60, 60)),
                      float(rng.uniform(-170, 170)),
                      float(rng.uniform(50, 6000)), 12, 16))
    return cases


@pytest.mark.parametrize("fn", ["morton", "cell_id", "cell_token",
                                "haversine_m", "cell_bounds",
                                "cell_intersects_circle", "covering_cells",
                                "covering_ranges"])
def test_cells_function_equals_the_reference(fn):
    pts = _seeded_points(3, 300)
    if fn == "morton":
        for lat, lng in pts:
            assert cells.morton(lat, lng) == ref_cells.morton(lat, lng)
    elif fn in ("cell_id", "cell_token"):
        for lat, lng in pts[:60]:
            for level in range(1, 31):
                cid = cells.cell_id(lat, lng, level)
                assert cid == ref_cells.cell_id(lat, lng, level)
                if fn == "cell_token":
                    assert cells.cell_token(cid, level) == \
                        ref_cells.cell_token(cid, level)
    elif fn == "haversine_m":
        for (a, b), (c, d) in zip(pts, pts[1:]):
            assert cells.haversine_m(a, b, c, d) == \
                ref_cells.haversine_m(a, b, c, d)
    elif fn in ("cell_bounds", "cell_intersects_circle"):
        rng = np.random.default_rng(4)
        for lat, lng in pts[:80]:
            for level in (4, 12, 16, 22):
                cid = cells.cell_id(lat, lng, level)
                for c in (cid, cid + 1, max(0, cid - 3)):
                    if fn == "cell_bounds":
                        assert cells.cell_bounds(c, level) == \
                            ref_cells.cell_bounds(c, level)
                    else:
                        r = float(rng.uniform(1, 20000))
                        assert cells.cell_intersects_circle(
                            c, level, lat, lng, r) == \
                            ref_cells.cell_intersects_circle(
                                c, level, lat, lng, r)
    elif fn == "covering_cells":
        capped = 0
        for lat, lng, r, level, max_level in _covering_cases():
            for lv in (level, max_level):
                got = cells.covering_cells(lat, lng, r, lv)
                assert got == ref_cells.covering_cells(lat, lng, r, lv)
                capped += len(got) >= cells.MAX_COVERING_CELLS
        assert capped, "no case reached the covering cap"
    else:
        whole = 0
        for lat, lng, r, level, max_level in _covering_cases():
            got = cells.covering_ranges(lat, lng, r, level, max_level)
            assert got == ref_cells.covering_ranges(lat, lng, r, level,
                                                    max_level)
            whole += sum(v is None for v in got.values())
        assert whole, "no case took a whole-cell path"


def test_morton_batch_equals_morton():
    pts = _seeded_points(5, 5000)
    lat = np.array([p[0] for p in pts] + [1e-300, -1e-300, 45.0])
    lng = np.array([p[1] for p in pts] + [-1e-300, 1e-300, -0.0])
    got = cells.morton_batch(lat, lng)
    assert got.dtype == np.uint64
    assert [int(x) for x in got] == [cells.morton(float(a), float(b))
                                    for a, b in zip(lat, lng)]


# ------------------------------------------------------- clients on servers


class GeoBox:
    """One package's servers: two RpcServers, the two geo tables of
    PARTITIONS partitions each, partition p of each on node p % 2."""

    def __init__(self, root, kind: str):
        transport = port_transport if kind == "port" else ref_transport
        client = port_client if kind == "port" else ref_client
        self.rpcs, self.servers = [], {name: [] for name in APPS}
        addr = {name: {} for name in APPS}
        for node in range(2):
            svc = ReplicaService() if kind == "port" else RefService()
            rpc = transport.RpcServer()
            if kind == "ref":
                # poll the accept loop as often as the port's does
                rpc._thread = threading.Thread(
                    target=rpc._srv.serve_forever,
                    kwargs={"poll_interval": 0.05}, daemon=True)
            rpc.start()
            for name, app_id in APPS.items():
                for p in range(node, PARTITIONS, 2):
                    path = str(root / f"{kind}_{name}_{p}")
                    if kind == "port":
                        srv = PegasusServer(
                            path, app_id=app_id, pidx=p, server=f"n{node}",
                            options=EngineOptions(device="cpu"))
                    else:
                        srv = RefServer(path, app_id=app_id, pidx=p,
                                        options=RefOptions(backend="cpu"),
                                        server=f"n{node}")
                    svc.add_replica(srv, PARTITIONS)
                    self.servers[name].append(srv)
                    addr[name][p] = rpc.address
            rpc.register_serverlet(svc)
            self.rpcs.append(rpc)
        self.clients = {
            name: client.PegasusClient(client.StaticResolver(
                app_id, [addr[name][p] for p in range(PARTITIONS)]))
            for name, app_id in APPS.items()}
        geo_cls = GeoClient if kind == "port" else RefGeo
        self.geo = geo_cls(self.clients["main"], self.clients["idx"])

    def digests(self) -> dict:
        return {name: sorted((s.pidx, s.engine.state_digest(now=0)["digest"])
                             for s in srvs)
                for name, srvs in self.servers.items()}

    def close(self):
        self.geo.close()
        for c in self.clients.values():
            c.close()
        for r in self.rpcs:
            r.stop()
        for srvs in self.servers.values():
            for s in srvs:
                s.close()


def _fill(geo, lat, lng) -> dict:
    """-> {hash_key: (lat, lng, value)} of every point written."""
    known = {}
    for i, (a, b) in enumerate(zip(lat, lng)):
        hk = b"p%07d" % i
        geo.set_geo_data(float(a), float(b), hk, b"s", b"v%d" % i)
        known[hk] = (float(a), float(b),
                     geo.codec.encode(b"v%d" % i, float(a), float(b)))
    return known


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    root = tmp_path_factory.mktemp("geo")
    mp = pytest.MonkeyPatch()
    import time

    mp.setattr(port_rs, "time", _FrozenTime(time))
    mp.setattr(ref_rs, "time", _FrozenTime(time))
    made = {}
    try:
        lat, lng = _points(6)
        for kind in ("port", "ref"):
            made[kind] = GeoBox(root, kind)
            known = _fill(made[kind].geo, lat, lng)
        yield made, known
    finally:
        for b in made.values():
            b.close()
        mp.undo()
        # the pipeline pools are module globals: stop them before joining
        # every tracked executor, or the next module finds them shut
        stop_pools()
        TRACKED.join_all(timeout_s=5.0)


def _brute(known: dict, lat: float, lng: float, radius: float) -> list:
    out = []
    for hk, (a, b, v) in known.items():
        d = cells.haversine_m(lat, lng, a, b)
        if d <= radius:
            out.append((d, hk, b"s", v))
    return sorted(out)


def _centres(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(float(CENTER[0] + rng.uniform(-0.8 * BOX, 0.8 * BOX)),
             float(CENTER[1] + rng.uniform(-0.8 * BOX, 0.8 * BOX)))
            for _ in range(n)]


@pytest.mark.parametrize("radius", [150.0, 500.0, 1500.0])
def test_search_answers_equal_the_reference_and_a_brute_force(boxes,
                                                              radius):
    made, known = boxes
    found = 0
    for lat, lng in _centres(int(radius), 12):
        port = made["port"].geo.search_radial(lat, lng, radius)
        ref = made["ref"].geo.search_radial(lat, lng, radius)
        # ties in distance keep scan order; compare as sets, then order
        assert sorted(port) == sorted(ref) == _brute(known, lat, lng, radius)
        assert [r[0] for r in port] == sorted(r[0] for r in port)
        found += len(port)
    assert found > 0


def test_nearest_count_and_by_key_equal_the_reference(boxes):
    made, known = boxes
    for lat, lng in _centres(9, 8):
        port = made["port"].geo.search_radial(lat, lng, 1200.0, count=5)
        ref = made["ref"].geo.search_radial(lat, lng, 1200.0, count=5)
        assert port == ref
        assert port == _brute(known, lat, lng, 1200.0)[:5]
    for i in (0, 17, 333):
        hk = b"p%07d" % i
        assert made["port"].geo.search_radial_by_key(hk, b"s", 400.0) == \
            made["ref"].geo.search_radial_by_key(hk, b"s", 400.0)
        for j in (1, 900):
            other = b"p%07d" % j
            assert made["port"].geo.distance(hk, b"s", other, b"s") == \
                made["ref"].geo.distance(hk, b"s", other, b"s")
    assert made["port"].geo.search_radial_by_key(b"none", b"s", 400.0) == []


def test_serial_scans_equal_the_threaded_ones(boxes):
    made, _ = boxes
    geo = made["port"].geo
    lat, lng = _centres(10, 1)[0]
    threaded = geo.search_radial(lat, lng, 900.0)
    geo.scan_threads, saved = 1, geo.scan_threads
    try:
        assert geo.search_radial(lat, lng, 900.0) == threaded
    finally:
        geo.scan_threads = saved


def test_tables_digest_equal_then_a_delete_removes_both_rows(boxes):
    made, known = boxes
    assert made["port"].digests() == made["ref"].digests()
    hk = b"p%07d" % 42
    lat, lng, _ = known[hk]
    near = made["port"].geo.search_radial(lat, lng, 1.0)
    assert any(r[1] == hk for r in near)
    for kind in ("port", "ref"):
        made[kind].geo.delete(hk, b"s")
        assert made[kind].geo.get(hk, b"s") is None
        assert not any(r[1] == hk for r in
                       made[kind].geo.search_radial(lat, lng, 1.0))
    # the geo table's row is gone too, not just filtered
    ghk = cells.cell_token(cells.cell_id(lat, lng, 12), 12)
    rows = list(made["port"].clients["idx"].get_scanner(ghk))
    assert not any(hk in gsk for _, gsk, _ in rows)
    assert made["port"].digests() == made["ref"].digests()
    known.pop(hk)


@pytest.mark.parametrize("option,env,device_calls", [
    (None, None, 0), (1, None, 1), (None, "1", 1), (2, "1", 0)])
def test_device_read_min_batch_decides_a_lone_range(tmp_path, monkeypatch,
                                                    option, env,
                                                    device_calls):
    """A lone range (a geo scan's one range per frame) resolves on the
    device path only at a min batch of 1: EngineOptions'
    device_read_min_batch, else PEGASUS_DEVICE_READ_MIN_BATCH, else 2,
    as the reference reads them; the rows are the host scan's either
    way."""
    from pegasus_tpu_torch.base.key_schema import generate_key
    from pegasus_tpu_torch.base.value_schema import SCHEMAS
    from pegasus_tpu_torch.engine.db import LsmEngine
    from pegasus_tpu_torch.runtime.tracing import COMPACT_TRACER

    if env is None:
        monkeypatch.delenv("PEGASUS_DEVICE_READ_MIN_BATCH", raising=False)
    else:
        monkeypatch.setenv("PEGASUS_DEVICE_READ_MIN_BATCH", env)
    eng = LsmEngine(str(tmp_path), EngineOptions(
        device="cpu", device_read_min_batch=option))
    try:
        for i in range(50):
            eng.put(generate_key(b"hk", b"s%02d" % i),
                    SCHEMAS[2].generate_value(0, 0, b"v%d" % i))
        eng.flush()
        eng.wait_primes()
        start, stop = generate_key(b"hk", b"s10"), generate_key(b"hk", b"s20")
        with COMPACT_TRACER.session() as sess:
            rows = list(eng.scan_range_batch([(start, stop)], now=0)[0])
        assert sess.summary().get("read.range", {}).get("calls", 0) == \
            device_calls
        assert rows == list(eng.scan(start, stop, now=0))
        assert len(rows) == 10
    finally:
        eng.close()
