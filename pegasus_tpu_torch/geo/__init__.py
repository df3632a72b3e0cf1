"""Geo: the Morton-cell spatial index over two tables (port of
pegasus_tpu/geo/)."""

from .cells import cell_id, cell_token, covering_cells, haversine_m, morton
from .geo_client import GeoClient
from .latlng_codec import LatlngCodec

__all__ = ["GeoClient", "LatlngCodec", "cell_id", "cell_token",
           "covering_cells", "haversine_m", "morton"]
