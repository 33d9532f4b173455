"""WGS84 -> local ENU metric frame anchored at the first fix (port of the
reference package's ``utils/gps.py``; reference: src/util/gps.hpp:9-62),
for the CLI's CSV GPS rows and ``VioApi.add_echo``'s gps / rtkgps echoes."""
from __future__ import annotations

import math
from typing import Optional, Tuple

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)


class GpsToLocalConverter:
    def __init__(self):
        self._anchor: Optional[Tuple[float, float, float]] = None
        self._scale: Optional[Tuple[float, float]] = None

    def convert(self, latitude: float, longitude: float, altitude: float = 0.0):
        """Return local (east, north, up) meters relative to the first fix."""
        if self._anchor is None:
            self._anchor = (latitude, longitude, altitude)
            lat = math.radians(latitude)
            sin_lat = math.sin(lat)
            # meridian & prime-vertical radii of curvature
            den = math.sqrt(1 - _E2 * sin_lat * sin_lat)
            m = _A * (1 - _E2) / den**3
            n = _A / den
            self._scale = (n * math.cos(lat), m)
        lat0, lon0, alt0 = self._anchor
        east = math.radians(longitude - lon0) * self._scale[0]
        north = math.radians(latitude - lat0) * self._scale[1]
        up = altitude - alt0
        return east, north, up
