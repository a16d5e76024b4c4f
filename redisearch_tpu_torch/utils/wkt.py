# Copy of redisearch_tpu/utils/wkt.py: the port imports nothing of the JAX package.
"""WKT geometry parsing + vectorized spatial predicates.

TPU-native replacement for the reference's GEOMETRY fields backed by a
Boost.Geometry R-tree (reference: src/geometry/rtree.cpp, geometry_api.cpp).
On TPU an R-tree's pointer-chasing is hostile; with the dense-column design
we instead keep parsed shapes host-side (numpy vertex arrays) and evaluate
WITHIN/CONTAINS/INTERSECTS/DISJOINT as vectorized numpy predicate sweeps over
all candidate shapes (exact point-in-polygon via winding; polygon-polygon via
bbox + edge intersection + containment tests).  SPHERICAL fields evaluate in
a gnomonic tangent plane about the query shape, making the planar predicates
exact for great-circle (geodesic) polygon edges — see _gnomonic.

Supports POINT and POLYGON with interior rings (holes): point-in-polygon
excludes holes, polygon WITHIN fails across hole boundaries or around
enclosed holes, INTERSECTS sees hole-boundary crossings — matching
Boost.Geometry's evaluation of interior rings (reference:
src/geometry/rtree.cpp).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from .errors import WrongFieldType


@dataclasses.dataclass
class Shape:
    kind: str                     # "point" | "polygon"
    coords: np.ndarray            # point: (2,), polygon: (n, 2) outer ring
    holes: list = dataclasses.field(default_factory=list)
    bbox: tuple = (0.0, 0.0, 0.0, 0.0)  # minx, miny, maxx, maxy

    def __post_init__(self):
        c = self.coords.reshape(-1, 2)
        self.bbox = (float(c[:, 0].min()), float(c[:, 1].min()),
                     float(c[:, 0].max()), float(c[:, 1].max()))


_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def _parse_ring(txt: str) -> np.ndarray:
    pts = []
    for pair in txt.split(","):
        nums = re.findall(_NUM, pair)
        if len(nums) < 2:
            raise WrongFieldType(f"bad WKT ring coordinate: {pair!r}")
        pts.append((float(nums[0]), float(nums[1])))
    return np.asarray(pts, np.float64)


def parse(text: str) -> Shape:
    """Parse a WKT POINT or POLYGON string."""
    t = text.strip()
    up = t.upper()
    if up.startswith("POINT"):
        nums = re.findall(_NUM, t)
        if len(nums) < 2:
            raise WrongFieldType(f"bad WKT POINT: {text!r}")
        return Shape("point", np.asarray([float(nums[0]), float(nums[1])]))
    if up.startswith("POLYGON"):
        body = t[t.index("(") + 1:t.rindex(")")]
        rings = re.findall(r"\(([^()]*)\)", body)
        if not rings:
            raise WrongFieldType(f"bad WKT POLYGON: {text!r}")
        outer = _parse_ring(rings[0])
        holes = [_parse_ring(r) for r in rings[1:]]
        return Shape("polygon", outer, holes)
    raise WrongFieldType(f"unsupported WKT geometry: {text!r}")


# -- coordinate systems ----------------------------------------------------

def _lon_shift(shape: Shape, ref_lon: float) -> Shape:
    """Clone `shape` with its longitudes wrapped by a multiple of 360
    into the frame of `ref_lon` (fallback framing for shapes too large
    for the gnomonic projection below)."""
    c = shape.coords.reshape(-1, 2)
    shift = float(np.round((ref_lon - c[:, 0].mean()) / 360.0) * 360.0)
    if shift == 0.0:
        return shape
    c2 = c.copy()
    c2[:, 0] += shift
    holes = [h + np.asarray([shift, 0.0]) for h in shape.holes]
    coords = c2[0] if shape.kind == "point" else c2
    return Shape(shape.kind, coords, holes)


def _unit_vecs(lonlat: np.ndarray) -> np.ndarray:
    lon = np.radians(lonlat[:, 0])
    lat = np.radians(lonlat[:, 1])
    cl = np.cos(lat)
    return np.stack([cl * np.cos(lon), cl * np.sin(lon),
                     np.sin(lat)], axis=1)


def _gnomonic(shape: Shape, center: np.ndarray, east: np.ndarray,
              north: np.ndarray) -> Optional[Shape]:
    """Project a lon/lat shape onto the tangent plane at `center`
    (gnomonic: x = p.e / p.c, y = p.n / p.c).  Great circles map to
    straight lines, so the planar predicates below are EXACT for
    geodesic polygon edges on the sphere — the geographic
    (SPHERICAL) model of the reference (GEOMETRY_COORDS_Geographic,
    boost::geometry geographic cs; rtree.hpp:56).  The reference's
    geodesics live on the WGS84 ellipsoid; the spherical model here
    differs from it by <0.3% of edge length, vs whole-degree errors
    for planar lon/lat edges.  Returns None when a vertex leaves the
    open hemisphere around `center` (projection undefined) — caller
    falls back to lon-shifted planar evaluation."""

    def proj(lonlat2d):
        v = _unit_vecs(lonlat2d)
        t = v @ center
        if np.any(t <= 1e-9):
            return None
        return np.stack([(v @ east) / t, (v @ north) / t], axis=1)

    c = proj(shape.coords.reshape(-1, 2))
    if c is None:
        return None
    holes = []
    for h in shape.holes:
        hp = proj(h)
        if hp is None:
            return None
        holes.append(hp)
    coords = c[0] if shape.kind == "point" else c
    return Shape(shape.kind, coords, holes)


def _frame_pair(a: Optional[Shape], b: Shape, spherical: bool):
    """Bring both shapes into one planar evaluation frame.  Spherical:
    gnomonic tangent plane at b's center (exact geodesic edges), falling
    back to lon-wrap framing if either shape spans past the hemisphere
    boundary.  Flat (cartesian): shapes pass through untouched."""
    if a is None or not spherical:
        return a, b
    mid_lon = (b.bbox[0] + b.bbox[2]) / 2.0
    mid_lat = (b.bbox[1] + b.bbox[3]) / 2.0
    center = _unit_vecs(np.asarray([[mid_lon, mid_lat]]))[0]
    north = np.asarray([-np.sin(np.radians(mid_lat)) * np.cos(np.radians(mid_lon)),
                        -np.sin(np.radians(mid_lat)) * np.sin(np.radians(mid_lon)),
                        np.cos(np.radians(mid_lat))])
    east = np.cross(north, center)
    ap = _gnomonic(a, center, east, north)
    bp = _gnomonic(b, center, east, north)
    if ap is None or bp is None:
        return _lon_shift(a, mid_lon), b
    return ap, bp


# -- predicates ------------------------------------------------------------

def _point_in_ring(pt: np.ndarray, ring: np.ndarray) -> bool:
    """Even-odd rule point-in-polygon."""
    x, y = pt[0], pt[1]
    x0, y0 = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    crossings = np.sum(cond & (x < xint))
    return bool(crossings % 2 == 1)


def _point_in_polygon(pt: np.ndarray, poly: Shape) -> bool:
    if not (poly.bbox[0] <= pt[0] <= poly.bbox[2]
            and poly.bbox[1] <= pt[1] <= poly.bbox[3]):
        return False
    if not _point_in_ring(pt, poly.coords):
        return False
    return not any(_point_in_ring(pt, h) for h in poly.holes)


def _segments_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Any edge of ring a intersects any edge of ring b (vectorized)."""
    p1 = a
    p2 = np.roll(a, -1, axis=0)
    q1 = b
    q2 = np.roll(b, -1, axis=0)

    def cross(o, d, p):
        return ((d[..., 0] - o[..., 0]) * (p[..., 1] - o[..., 1])
                - (d[..., 1] - o[..., 1]) * (p[..., 0] - o[..., 0]))

    P1 = p1[:, None, :]
    P2 = p2[:, None, :]
    Q1 = q1[None, :, :]
    Q2 = q2[None, :, :]
    d1 = cross(P1, P2, Q1)
    d2 = cross(P1, P2, Q2)
    d3 = cross(Q1, Q2, P1)
    d4 = cross(Q1, Q2, P2)
    proper = ((d1 * d2) < 0) & ((d3 * d4) < 0)
    return bool(proper.any())


def _bbox_disjoint(a: Shape, b: Shape) -> bool:
    return (a.bbox[2] < b.bbox[0] or b.bbox[2] < a.bbox[0]
            or a.bbox[3] < b.bbox[1] or b.bbox[3] < a.bbox[1])


def within(inner: Optional[Shape], outer: Shape,
           spherical: bool = False) -> bool:
    """inner WITHIN outer."""
    inner, outer = _frame_pair(inner, outer, spherical)
    if inner is None:
        return False
    if _bbox_disjoint(inner, outer):
        return False
    if inner.kind == "point":
        if outer.kind == "point":
            return bool(np.allclose(inner.coords, outer.coords))
        return _point_in_polygon(inner.coords, outer)
    if outer.kind == "point":
        return False
    if _segments_intersect(inner.coords, outer.coords):
        return False
    for h in outer.holes:
        # crossing a hole boundary, or fully surrounding a hole, carves
        # area out of `inner` (reference: Boost.Geometry evaluates
        # interior rings — src/geometry/rtree.cpp predicates)
        if _segments_intersect(inner.coords, h):
            return False
        if _point_in_ring(h[0], inner.coords):
            return False
    return all(_point_in_polygon(p, outer) for p in inner.coords)


def contains(a: Optional[Shape], b: Shape,
             spherical: bool = False) -> bool:
    if a is None:
        return False
    b2, a2 = _frame_pair(b, a, spherical)
    return within(b2, a2)


def intersects(a: Optional[Shape], b: Shape,
               spherical: bool = False) -> bool:
    a, b = _frame_pair(a, b, spherical)
    if a is None:
        return False
    if _bbox_disjoint(a, b):
        return False
    if a.kind == "point":
        return within(a, b)
    if b.kind == "point":
        return within(b, a)
    if _segments_intersect(a.coords, b.coords):
        return True
    # a polygon straddling the other's interior-ring (hole) boundary
    # overlaps its solid region even without touching the outer ring
    if any(_segments_intersect(a.coords, h) for h in b.holes):
        return True
    if any(_segments_intersect(b.coords, h) for h in a.holes):
        return True
    return (_point_in_polygon(a.coords[0], b)
            or _point_in_polygon(b.coords[0], a))


def disjoint(a: Optional[Shape], b: Shape,
             spherical: bool = False) -> bool:
    if a is None:
        return False
    return not intersects(a, b, spherical)


PREDICATES = {
    "WITHIN": within,
    "CONTAINS": contains,
    "INTERSECTS": intersects,
    "DISJOINT": disjoint,
}
