"""HD-map geometry extraction (nuScenes map → vectorized polylines).

Copy of the JAX package's ``datasets/map_extractor.py`` (host numpy), which
re-designs ``lidargen/dataset/map_utils/{nuscmap_extractor.py,utils.py}``:
the geometry core (ring orientation, ROI clipping, min-rectangle direction
for ped-crossing merging) is pure numpy and unit-tested; the
devkit/shapely-touching :class:`NuscMapExtractor` is gated on those imports
(neither ships in this environment) and mirrors the reference pipeline:
lane+road dividers → ``divider``, merged ped crossings → ``ped_crossing``,
contours of the road∪lane union (exteriors clockwise, interiors
counter-clockwise so the drivable area is always on the right-hand side) →
``boundary``.
"""

from __future__ import annotations

import numpy as np

MAP_LOCATIONS = (
    "boston-seaport",
    "singapore-hollandvillage",
    "singapore-onenorth",
    "singapore-queenstown",
)


def signed_area(ring: np.ndarray) -> float:
    """Shoelace signed area of a closed (P, 2) ring (positive = CCW)."""
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def is_ccw(ring: np.ndarray) -> bool:
    return signed_area(ring) > 0


def ensure_orientation(ring: np.ndarray, ccw: bool) -> np.ndarray:
    """Reverse the ring if needed; cf. ``utils.py:63-75`` orientation rules."""
    return ring if is_ccw(ring) == ccw else ring[::-1]


def clip_polyline_to_box(
    coords: np.ndarray, xmin: float, ymin: float, xmax: float, ymax: float
) -> list[np.ndarray]:
    """Clip a (P, 2) polyline to an axis-aligned box (Liang–Barsky per
    segment, adjacent kept segments merged) — the numpy equivalent of the
    reference's ``ext.intersection(local_patch)`` + ``linemerge``."""
    pieces: list[list[np.ndarray]] = []
    open_piece: list[np.ndarray] | None = None
    for a, b in zip(coords[:-1], coords[1:]):
        d = b - a
        t0, t1 = 0.0, 1.0
        ok = True
        for p, q in (
            (-d[0], a[0] - xmin), (d[0], xmax - a[0]),
            (-d[1], a[1] - ymin), (d[1], ymax - a[1]),
        ):
            if p == 0:
                if q < 0:
                    ok = False
                    break
                continue
            r = q / p
            if p < 0:
                if r > t1:
                    ok = False
                    break
                t0 = max(t0, r)
            else:
                if r < t0:
                    ok = False
                    break
                t1 = min(t1, r)
        if not ok or t0 > t1:
            open_piece = None
            continue
        p0, p1 = a + t0 * d, a + t1 * d
        if open_piece is not None and np.allclose(open_piece[-1], p0):
            open_piece.append(p1)
        else:
            open_piece = [p0, p1]
            pieces.append(open_piece)
        if t1 < 1.0:
            open_piece = None
    return [np.asarray(p) for p in pieces if len(p) >= 2]


def rect_direction(points: np.ndarray) -> tuple[np.ndarray, float]:
    """Longest edge (vector, length) of the minimum-area enclosing rectangle
    (rotating calipers over the convex hull); cf. ``nuscmap_extractor.py:46-53``."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, np.float64)
    hull = pts[ConvexHull(pts).vertices]
    edges = np.roll(hull, -1, axis=0) - hull
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    best = None
    for th in angles:
        rot = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
        proj = hull @ rot.T
        wh = proj.max(0) - proj.min(0)
        area = wh[0] * wh[1]
        if best is None or area < best[0]:
            axis = 0 if wh[0] >= wh[1] else 1
            direction = rot.T[:, axis] * wh[axis]
            best = (area, direction, float(wh[axis]))
    return best[1], best[2]


def aligned_groups(directions: list[tuple[np.ndarray, float]],
                   cos_thresh: float = 0.99) -> list[list[int]]:
    """Group indices whose rectangle directions are within ~8° (the
    reference's ``1 - |cos| < 0.01`` merge rule, ``nuscmap_extractor.py:75-80``)."""
    remain = list(range(len(directions)))
    groups = []
    while remain:
        i = remain.pop(0)
        v, n = directions[i]
        grp = [i]
        for j in list(remain):
            w, m = directions[j]
            cos = float(v @ w) / (n * m)
            if 1 - abs(cos) < 1 - cos_thresh:
                grp.append(j)
                remain.remove(j)
        groups.append(grp)
    return groups


class NuscMapExtractor:
    """cf. ``NuscMapExtractor`` (``nuscmap_extractor.py:13-159``); requires
    the nuScenes map expansion + shapely (gated)."""

    def __init__(self, data_root: str, roi_size):
        try:
            from nuscenes.map_expansion.map_api import (
                NuScenesMap,
                NuScenesMapExplorer,
            )
            from shapely.geometry import box
        except ImportError as e:
            raise ImportError(
                "NuscMapExtractor needs the nuScenes devkit map expansion and "
                "shapely; the numpy geometry core in this module works without "
                "them."
            ) from e
        self.roi_size = roi_size
        self.nusc_maps = {
            loc: NuScenesMap(dataroot=data_root, map_name=loc)
            for loc in MAP_LOCATIONS
        }
        self.map_explorer = {
            loc: NuScenesMapExplorer(m) for loc, m in self.nusc_maps.items()
        }
        self.local_patch = box(
            -roi_size[0] / 2, -roi_size[1] / 2, roi_size[0] / 2, roi_size[1] / 2
        )

    # -- shapely-side helpers -------------------------------------------------

    @staticmethod
    def _split(geom):
        if "Multi" in geom.geom_type or geom.geom_type == "GeometryCollection":
            return [g for g in geom.geoms if g.is_valid and not g.is_empty]
        return [geom] if geom.is_valid and not geom.is_empty else []

    def _union_ped(self, ped_geoms):
        dirs = [rect_direction(np.array(p.exterior.coords)) for p in ped_geoms]
        merged = []
        for grp in aligned_groups(dirs):
            u = ped_geoms[grp[0]]
            for j in grp[1:]:
                u = u.union(ped_geoms[j])
            merged.extend(self._split(u))
        return merged

    def _contour(self, ring, ccw: bool):
        from shapely import ops
        from shapely.geometry import LinearRing

        coords = np.array(ring.coords)
        ring = LinearRing(ensure_orientation(coords, ccw))
        lines = ring.intersection(self.local_patch)
        if lines.geom_type == "MultiLineString":
            lines = ops.linemerge(lines)
        return self._split(lines)

    def get_map_geom(self, location: str, translation, rotation) -> dict:
        """→ {'divider', 'ped_crossing', 'boundary', 'drivable_area'} lists;
        cf. ``nuscmap_extractor.py:87-159``."""
        from shapely import ops

        from .converter import quaternion_to_matrix

        yaw = float(
            np.degrees(
                np.arctan2(*quaternion_to_matrix(rotation)[[1, 0], 0])
            )
        )
        patch_box = (translation[0], translation[1], self.roi_size[1], self.roi_size[0])
        ex = self.map_explorer[location]

        dividers = []
        for layer in ("lane_divider", "road_divider"):
            for line in ex._get_layer_line(patch_box, yaw, layer):
                dividers += self._split(line)

        ped = []
        for p in ex._get_layer_polygon(patch_box, yaw, "ped_crossing"):
            ped += self._split(p)
        ped_lines = []
        for p in self._union_ped(ped):
            ped_lines += self._contour(p.exterior, ccw=True)

        roads = ex._get_layer_polygon(patch_box, yaw, "road_segment")
        lanes = ex._get_layer_polygon(patch_box, yaw, "lane")
        drivable = self._split(ops.unary_union([ops.unary_union(roads),
                                                ops.unary_union(lanes)]))
        boundaries = []
        for poly in drivable:
            boundaries += self._contour(poly.exterior, ccw=False)
            for inter in poly.interiors:
                boundaries += self._contour(inter, ccw=True)

        return dict(
            divider=dividers,
            ped_crossing=ped_lines,
            boundary=boundaries,
            drivable_area=drivable,
        )
