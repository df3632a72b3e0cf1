"""Spatial cell scheme: Morton (Z-order) curve over quantized lat/lng.

Port of pegasus_tpu/geo/cells.py, whole, plus `morton_batch`: the same
codes for a numpy array of points at once (bulk fills), equal to
`morton` point for point.

The upstream geo client indexes with s2geometry cell ids
(src/geo/lib/geo_client.h: hash_key = level-`min_level` S2 cell,
sort_key = deeper cell path). This scheme interleaves the bits of
quantized latitude/longitude into a Morton code instead; a "cell at
level L" is the top 2*L bits. Morton cells share S2's key property for
this workload (nearby points share prefixes), so the same dual-table
layout and covering-scan search work unchanged.

Level semantics: level L splits the world into 2^L x 2^L cells; cell edge
is ~(180/2^L) degrees of latitude (~20000km/2^L at the equator).
"""

import math

import numpy as np

EARTH_RADIUS_M = 6371000.9
_BITS = 30  # quantization bits per axis


def _quantize(v: float, lo: float, hi: float) -> int:
    x = (v - lo) / (hi - lo)
    return min((1 << _BITS) - 1, max(0, int(x * (1 << _BITS))))


def _spread(v: int) -> int:
    """Insert a zero bit between every bit of v (30 -> 60 bits)."""
    out = 0
    for i in range(_BITS):
        out |= ((v >> i) & 1) << (2 * i)
    return out


def morton(lat: float, lng: float) -> int:
    """60-bit interleaved cell code, lat bits even, lng bits odd."""
    return _spread(_quantize(lat, -90.0, 90.0)) | (
        _spread(_quantize(lng, -180.0, 180.0)) << 1)


def _spread_batch(v):
    """_spread over a uint64 array: the usual shift-and-mask bit
    interleave (30 -> 60 bits)."""
    x = v.astype(np.uint64) & np.uint64((1 << _BITS) - 1)
    for shift, mask in ((16, 0x0000FFFF0000FFFF), (8, 0x00FF00FF00FF00FF),
                        (4, 0x0F0F0F0F0F0F0F0F), (2, 0x3333333333333333),
                        (1, 0x5555555555555555)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def _quantize_batch(v, lo: float, hi: float):
    """_quantize over a float64 array: the same float64 quotient and
    product, truncated toward zero and clamped."""
    x = (np.asarray(v, np.float64) - lo) / (hi - lo)
    q = np.trunc(x * float(1 << _BITS))
    return np.clip(q, 0, (1 << _BITS) - 1).astype(np.uint64)


def morton_batch(lat, lng):
    """morton() of every (lat[i], lng[i]) -> np.uint64 array."""
    return _spread_batch(_quantize_batch(lat, -90.0, 90.0)) | (
        _spread_batch(_quantize_batch(lng, -180.0, 180.0)) << np.uint64(1))


def cell_id(lat: float, lng: float, level: int) -> int:
    """Top 2*level bits of the Morton code: the level-L cell."""
    return morton(lat, lng) >> (2 * (_BITS - level))


def cell_token(cid: int, level: int) -> bytes:
    """Fixed-width printable token for use as a hash_key."""
    width = -(-2 * level // 4)  # hex digits
    return b"%0*x" % (width, cid)


def haversine_m(lat1, lng1, lat2, lng2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lng2 - lng1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * EARTH_RADIUS_M * math.asin(min(1.0, math.sqrt(a)))


def cell_bounds(cid: int, level: int):
    """-> (lat_lo, lat_hi, lng_lo, lng_hi) of a level-L cell.

    A Morton cell is a rectangle in quantized (lat, lng) space: at level L
    the cell id carries L lat bits (even positions) and L lng bits (odd)."""
    lat_q = lng_q = 0
    for i in range(level):
        lat_q |= ((cid >> (2 * i)) & 1) << i
        lng_q |= ((cid >> (2 * i + 1)) & 1) << i
    span_lat = 180.0 / (1 << level)
    span_lng = 360.0 / (1 << level)
    lat_lo = -90.0 + lat_q * span_lat
    lng_lo = -180.0 + lng_q * span_lng
    return lat_lo, lat_lo + span_lat, lng_lo, lng_lo + span_lng


def cell_intersects_circle(cid: int, level: int, lat: float, lng: float,
                           radius_m: float) -> bool:
    """True when the cell rectangle and the search circle overlap: the
    haversine distance from the center to the nearest point of the
    rectangle is within the radius (no longitude wraparound — callers
    search city-scale radii)."""
    lat_lo, lat_hi, lng_lo, lng_hi = cell_bounds(cid, level)
    nlat = min(lat_hi, max(lat_lo, lat))
    nlng = min(lng_hi, max(lng_lo, lng))
    return haversine_m(lat, lng, nlat, nlng) <= radius_m


MAX_COVERING_CELLS = 4096


def covering_cells(lat: float, lng: float, radius_m: float, level: int) -> list:
    """Level-L cells covering the search circle's bounding box (the
    gen_search_cap covering role). The sample grid step matches the cell
    edge so no covering cell between samples is skipped, whatever the
    radius/level ratio; the cell count is capped (huge radii should use a
    coarser level, like S2 covering limits). Returns sorted unique ids."""
    dlat = math.degrees(radius_m / EARTH_RADIUS_M)
    coslat = max(0.01, math.cos(math.radians(lat)))
    dlng = math.degrees(radius_m / (EARTH_RADIUS_M * coslat))
    cell_h = 180.0 / (1 << level)   # cell edge in latitude degrees
    cell_w = 360.0 / (1 << level)
    # one sample per cell edge, uncapped — the MAX_COVERING_CELLS early
    # return below bounds the work; capping the STEP spacing instead would
    # silently skip cells between samples
    steps_lat = int(2 * dlat / cell_h) + 2
    steps_lng = int(2 * dlng / cell_w) + 2
    cells = set()
    for i in range(steps_lat + 1):
        for j in range(steps_lng + 1):
            la = min(90.0, max(-90.0, lat - dlat + 2 * dlat * i / steps_lat))
            ln = lng - dlng + 2 * dlng * j / steps_lng
            ln = (ln + 180.0) % 360.0 - 180.0
            cells.add(cell_id(la, ln, level))
            if len(cells) >= MAX_COVERING_CELLS:
                return sorted(cells)
    return sorted(cells)


MAX_RANGES_PER_CELL = 4    # like S2RegionCoverer's max_cells budget
FULL_SCAN_FRACTION = 0.5   # ranges covering most of a cell -> scan it all


def covering_ranges(lat: float, lng: float, radius_m: float, level: int,
                    max_level: int) -> dict:
    """Two-level covering for range-narrowed scans (the reference's
    gen_start_sort_key/gen_stop_sort_key, geo_client.cpp:433-454): cover
    the circle with level-`max_level` cells, then group them under their
    level-`level` ancestors.

    -> {ancestor_cell_id: None | [(start_morton, stop_morton)]}: None means
    the whole ancestor cell intersects (scan it all); otherwise the sorted,
    merged list of full-60-bit Morton ranges (stop exclusive) covering the
    circle inside that cell — everything outside the ranges is provably
    outside the circle and is never read."""
    if max_level <= level:
        return {c: None for c in covering_cells(lat, lng, radius_m, level)}
    shift_m = 2 * (_BITS - max_level)
    rel = 2 * (max_level - level)
    raw = covering_cells(lat, lng, radius_m, max_level)
    # a capped covering at max_level has holes (early return mid-grid);
    # fall back to whole-cell scans at the coarse level rather than
    # silently missing results — the cap must be tested BEFORE the circle
    # filter, which can shrink an incomplete covering back under the cap
    if len(raw) >= MAX_COVERING_CELLS:
        return {c: None for c in covering_cells(lat, lng, radius_m, level)}
    deep = [c for c in raw
            if cell_intersects_circle(c, max_level, lat, lng, radius_m)]
    out = {}
    full = 1 << rel  # descendants per ancestor
    by_anc = {}
    for c in deep:
        by_anc.setdefault(c >> rel, []).append(c)
    for anc, children in by_anc.items():
        # a scan task costs a round trip: nearly-full cells scan whole, and
        # the range count per cell is budgeted by merging the smallest gaps
        # (the role of S2RegionCoverer's max_cells budget)
        if len(children) >= full * FULL_SCAN_FRACTION:
            out[anc] = None
            continue
        ranges = []
        start = prev = children[0]
        for c in children[1:]:
            if c == prev + 1:
                prev = c
                continue
            ranges.append([start, prev + 1])
            start = prev = c
        ranges.append([start, prev + 1])
        while len(ranges) > MAX_RANGES_PER_CELL:
            gaps = [(ranges[i + 1][0] - ranges[i][1], i)
                    for i in range(len(ranges) - 1)]
            _, i = min(gaps)
            ranges[i][1] = ranges[i + 1][1]
            del ranges[i + 1]
        out[anc] = [(s << shift_m, e << shift_m) for s, e in ranges]
    return out
