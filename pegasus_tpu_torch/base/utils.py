"""Base utilities: the expire_ts clock and C-style escaping for logs."""

import time

# TTL timestamps are seconds since 2016-01-01 00:00:00 GMT
epoch_begin = 1451606400


def epoch_now(now: float = None) -> int:
    """Seconds since the 2016 epoch; the expire_ts clock."""
    return int(now if now is not None else time.time()) - epoch_begin


_PRINTABLE = set(range(0x20, 0x7F)) - {ord('"'), ord("\\")}


def c_escape_string(data: bytes, always_escape: bool = False) -> str:
    """C-style escaping for log and shell display (the same text as
    pegasus_tpu's); always_escape escapes every byte."""
    out = []
    for b in data:
        if not always_escape and b in _PRINTABLE:
            out.append(chr(b))
        elif b == ord('"') and not always_escape:
            out.append('\\"')
        elif b == ord("\\") and not always_escape:
            out.append("\\\\")
        else:
            out.append(f"\\x{b:02X}")
    return "".join(out)
