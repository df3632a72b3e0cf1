"""Base utilities: the expire_ts clock."""

import time

# TTL timestamps are seconds since 2016-01-01 00:00:00 GMT
epoch_begin = 1451606400


def epoch_now(now: float = None) -> int:
    """Seconds since the 2016 epoch; the expire_ts clock."""
    return int(now if now is not None else time.time()) - epoch_begin
