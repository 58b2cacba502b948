"""Equal-area world grid (counterpart of ``terrain_diffusion_tpu.data.world_grid``).

Grid of approximately equal-area cells between -60 and 60 degrees latitude,
used to key DEM downloads and dataset chunks.
"""
from __future__ import annotations

import numpy as np

EARTH_RADIUS = 6378000.0
MIN_LAT, MAX_LAT = -60.0, 60.0


def create_equal_area_grid(target_size) -> list[tuple[float, float, float, float]]:
    """Cells (min_lon, min_lat, max_lon, max_lat) of ~target_size meters."""
    base_lon = np.degrees(target_size[0] / EARTH_RADIUS)
    base_lat = np.degrees(target_size[1] / EARTH_RADIUS)
    cells = []
    lat = MIN_LAT
    while lat + base_lat < MAX_LAT:
        next_lat = lat + base_lat
        cos_lat = np.cos(np.radians(lat + (next_lat - lat) / 2))
        lon_spacing = base_lon / cos_lat
        lon = -180.0
        while lon < 180.0:
            next_lon = lon + lon_spacing
            if next_lon > 180.0:
                break
            cells.append((lon, lat, next_lon, next_lat))
            lon += lon_spacing
        lat = next_lat
    return cells


def cell_id(index: int) -> str:
    return str(index)
