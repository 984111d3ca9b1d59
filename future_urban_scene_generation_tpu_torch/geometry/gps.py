"""Trajectory pixel -> GPS -> metric ground-plane conversion, float64 on the host.

Counterpart of the JAX package's geometry/gps.py (:22-76; the reference's
utils/gps_utils.py:7-56): bbox ground-contact points go through the inverse
pixel->GPS homography, a bounding GPS rectangle is measured with the haversine
geodesic (R = 6371 km), and each GPS coordinate is interpolated linearly into meters
inside that rectangle.

GPS coordinates carry meter-scale information in the 5th-6th decimal place on top of
a ~45-degree base, far beyond float32, and the stage is a 6-point, once-per-request
computation: it runs in float64 numpy on the host, and the service casts the meters
to float32 at the device boundary.
"""
from __future__ import annotations

import numpy as np

EARTH_RADIUS_M = 6371.0 * 1000.0


def geodesic_distance(point1, point2):
    """Haversine distance in meters between (lat, lon) points (gps_utils.py:7-16)."""
    lat1, lon1 = np.radians(point1[..., 0]), np.radians(point1[..., 1])
    lat2, lon2 = np.radians(point2[..., 0]), np.radians(point2[..., 1])
    dlat = lat1 - lat2
    dlon = lon1 - lon2
    a = np.sin(dlat / 2.0) ** 2 + np.cos(lat2) * np.cos(lat1) * np.sin(dlon / 2.0) ** 2
    c = 2.0 * np.arctan2(np.sqrt(a), np.sqrt(1.0 - a))
    return EARTH_RADIUS_M * c


def pixels_to_gps(points_px, inv_homography):
    """Project (T, 2) pixel points through the inverse homography -> (T, 2) GPS."""
    ones = np.ones((points_px.shape[0], 1), points_px.dtype)
    h_pts = np.concatenate([points_px, ones], axis=1)
    proj = h_pts @ inv_homography.T
    return proj[:, :2] / proj[:, 2:3]


def gps_to_meters(gps):
    """Interpolate (T, 2) GPS coords into meters inside their bounding rectangle
    (gps_utils.py:38-56)."""
    tl = np.min(gps, axis=0)  # (lat_min, lon_min)
    br = np.max(gps, axis=0)  # (lat_max, lon_max)
    bl = np.stack([tl[0], br[1]])
    tr = np.stack([br[0], tl[1]])
    br_meter_lat = geodesic_distance(br, bl)  # extent along latitude
    br_meter_lon = geodesic_distance(br, tr)  # extent along longitude
    lat_diff = br[0] - tl[0]
    lon_diff = br[1] - tl[1]
    lat_diff = np.where(np.abs(lat_diff) < 1e-15, 1e-15, lat_diff)
    lon_diff = np.where(np.abs(lon_diff) < 1e-15, 1e-15, lon_diff)
    m_lat = (gps[:, 0] - tl[0]) / lat_diff * br_meter_lat
    m_lon = (gps[:, 1] - tl[1]) / lon_diff * br_meter_lon
    return np.stack([m_lat, m_lon], axis=1)


def trajectory_to_meters(points_px, inv_homography):
    """Pixel ground-contact trajectory (T, 2) float64 -> metric coordinates (T, 2)."""
    points_px = np.asarray(points_px, np.float64)
    return gps_to_meters(pixels_to_gps(points_px, np.asarray(inv_homography, np.float64)))
