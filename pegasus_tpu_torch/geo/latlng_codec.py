"""Extract latitude/longitude from '|'-separated value fields.

Port of pegasus_tpu/geo/latlng_codec.py, whole (upstream
src/geo/lib/latlng_codec.{h,cpp}): geo values carry coordinates in two
configurable indices of a '|'-separated string; the codec pulls them out
(and can patch them back) without understanding the rest of the value.
"""


class LatlngCodec:
    def __init__(self, lat_index: int = 5, lng_index: int = 4):
        self.lat_index = lat_index
        self.lng_index = lng_index

    def decode(self, value: bytes):
        """-> (lat, lng) or None when the fields are absent/invalid."""
        parts = value.split(b"|")
        hi = max(self.lat_index, self.lng_index)
        if len(parts) <= hi:
            return None
        try:
            lat = float(parts[self.lat_index])
            lng = float(parts[self.lng_index])
        except ValueError:
            return None
        if not (-90.0 <= lat <= 90.0 and -180.0 <= lng <= 180.0):
            return None
        return lat, lng

    def encode(self, value: bytes, lat: float, lng: float) -> bytes:
        parts = value.split(b"|")
        hi = max(self.lat_index, self.lng_index)
        while len(parts) <= hi:
            parts.append(b"")
        parts[self.lat_index] = repr(lat).encode()
        parts[self.lng_index] = repr(lng).encode()
        return b"|".join(parts)
