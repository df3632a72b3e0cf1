"""Value expiry check shared by the read paths.

expire_ts is seconds since 2016-01-01 UTC (see utils.epoch_begin); 0 means
no TTL.
"""


def check_if_ts_expired(epoch_now: int, expire_ts: int) -> bool:
    return 0 < expire_ts <= epoch_now
