"""Geospatial primitives for the geo scalar functions.

Reference: src/common/function/src/scalars/geo/{geohash,measure,wkt}.rs
(the h3/s2 cell systems are not reimplemented — geohash is the cell
encoding here).  Pure math, shared by the host scalar functions in
query/exprs.py.
"""

from __future__ import annotations

import math

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"
_EARTH_RADIUS_M = 6371008.8  # mean radius, matches the geo crate


def geohash_encode(lat: float, lng: float, precision: int) -> str:
    """Standard geohash (interleaved lng/lat bisection, base32)."""
    if not (-90.0 <= lat <= 90.0 and -180.0 <= lng <= 180.0):
        raise ValueError(f"invalid coordinate ({lat}, {lng})")
    if not (1 <= precision <= 12):
        raise ValueError(f"geohash precision {precision} out of [1, 12]")
    lat_lo, lat_hi = -90.0, 90.0
    lng_lo, lng_hi = -180.0, 180.0
    out = []
    bit = 0
    ch = 0
    even = True  # lng first
    while len(out) < precision:
        if even:
            mid = (lng_lo + lng_hi) / 2
            if lng >= mid:
                ch = (ch << 1) | 1
                lng_lo = mid
            else:
                ch <<= 1
                lng_hi = mid
        else:
            mid = (lat_lo + lat_hi) / 2
            if lat >= mid:
                ch = (ch << 1) | 1
                lat_lo = mid
            else:
                ch <<= 1
                lat_hi = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_BASE32[ch])
            bit = 0
            ch = 0
    return "".join(out)


def geohash_decode(gh: str) -> tuple[float, float, float, float]:
    """→ (lat_lo, lat_hi, lng_lo, lng_hi) bounding box."""
    lat_lo, lat_hi = -90.0, 90.0
    lng_lo, lng_hi = -180.0, 180.0
    even = True
    for c in gh.lower():
        idx = _BASE32.index(c)
        for shift in range(4, -1, -1):
            bit = (idx >> shift) & 1
            if even:
                mid = (lng_lo + lng_hi) / 2
                if bit:
                    lng_lo = mid
                else:
                    lng_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return lat_lo, lat_hi, lng_lo, lng_hi


def geohash_neighbours(gh: str) -> list[str]:
    """The 8 surrounding cells (by center-point re-encoding)."""
    lat_lo, lat_hi, lng_lo, lng_hi = geohash_decode(gh)
    clat = (lat_lo + lat_hi) / 2
    clng = (lng_lo + lng_hi) / 2
    dlat = lat_hi - lat_lo
    dlng = lng_hi - lng_lo
    out = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            lat = clat + dy * dlat
            lng = clng + dx * dlng
            if not -90.0 <= lat <= 90.0:
                continue  # off the pole
            lng = ((lng + 180.0) % 360.0) - 180.0  # wrap the antimeridian
            out.append(geohash_encode(lat, lng, len(gh)))
    return out


def parse_wkt_point(wkt: str) -> tuple[float, float]:
    """'POINT(lng lat)' → (lng, lat)."""
    s = wkt.strip()
    up = s.upper()
    if not up.startswith("POINT"):
        raise ValueError(f"not a WKT point: {wkt!r}")
    inner = s[s.index("(") + 1:s.rindex(")")].split()
    if len(inner) != 2:
        raise ValueError(f"bad WKT point: {wkt!r}")
    return float(inner[0]), float(inner[1])


def parse_wkt_polygon(wkt: str) -> list[tuple[float, float]]:
    """'POLYGON((x y, x y, ...))' → outer ring [(lng, lat), ...]."""
    s = wkt.strip()
    if not s.upper().startswith("POLYGON"):
        raise ValueError(f"not a WKT polygon: {wkt!r}")
    inner = s[s.index("((") + 2:s.index("))")]
    ring = []
    for pair in inner.split(","):
        x, y = pair.split()
        ring.append((float(x), float(y)))
    return ring


def euclidean_distance_deg(p1: str, p2: str) -> float:
    """Planar distance in degrees between two WKT points (reference
    st_distance, geo crate Euclidean on lat/lng)."""
    x1, y1 = parse_wkt_point(p1)
    x2, y2 = parse_wkt_point(p2)
    return math.hypot(x2 - x1, y2 - y1)


def haversine_distance_m(p1: str, p2: str) -> float:
    """Great-circle distance in meters (reference st_distance_sphere_m)."""
    x1, y1 = parse_wkt_point(p1)
    x2, y2 = parse_wkt_point(p2)
    phi1, phi2 = math.radians(y1), math.radians(y2)
    dphi = phi2 - phi1
    dlmb = math.radians(x2 - x1)
    a = (math.sin(dphi / 2) ** 2
         + math.cos(phi1) * math.cos(phi2) * math.sin(dlmb / 2) ** 2)
    return 2 * _EARTH_RADIUS_M * math.asin(math.sqrt(a))


def polygon_area_deg2(wkt: str) -> float:
    """Planar shoelace area in degrees² (reference st_area semantics,
    geo crate unsigned planar area on raw coordinates)."""
    ring = parse_wkt_polygon(wkt)
    if len(ring) < 3:
        return 0.0
    acc = 0.0
    for (x1, y1), (x2, y2) in zip(ring, ring[1:] + ring[:1]):
        acc += x1 * y2 - x2 * y1
    return abs(acc) / 2.0
