"""Deterministic failure injection, modeled on dsn::fail points.

Port of pegasus_tpu/runtime/fail_points.py, whole: the same registry, the
same action mini-language and the same point names, so a test arms one
point in both packages with one string. Call sites in the port: the batch
dispatch (`serve.native`, `serve.dispatch`), the mutation log's group
commit (`plog.group`), the block-shipped learn (`learn.ship`), the
engine scrub (`scrub.verify`), the audit's digest (`audit.digest`) and
the compaction scheduler's tick (`compact.sched`).

    "return()"     -> hook returns the given (or default) injected value
    "return(v)"    -> hook returns v (string)
    "10%return()"  -> 10% probability
    "3*return()"   -> only first 3 hits
    "off()"        -> disabled
    "print()"      -> log and continue
    "sleep(ms)"    -> block the calling thread ms milliseconds, continue
    "raise(msg)"   -> raise FailPointError(msg) from the hook
"""

import random
import re
import threading
import time

_ACTION_RE = re.compile(
    r"^\s*(?:(?P<pct>\d+(?:\.\d+)?)%)?\s*(?:(?P<cnt>\d+)\*)?\s*(?P<verb>return|off|print|sleep|raise)\((?P<arg>[^)]*)\)\s*$"
)


class FailPointError(RuntimeError):
    """Raised by a fail point armed with the 'raise(msg)' verb."""


class _FailPointRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._points = {}
        self._enabled = False
        # non-'off' points; with _enabled it forms the unlocked fast-path
        # check in evaluate(): once every point is healed, hot-path hooks
        # (serve.dispatch runs per RPC) read one attribute
        self._active = 0
        self._rng = random.Random(0)

    def setup(self):
        with self._lock:
            self._enabled = True
            self._points.clear()
            self._active = 0

    def teardown(self):
        with self._lock:
            self._enabled = False
            self._points.clear()
            self._active = 0

    def arm(self, name: str, action: str):
        """cfg() that also enables the registry without clearing points
        already armed (arming points one at a time in a live process)."""
        with self._lock:
            self._enabled = True
        self.cfg(name, action)

    def cfg(self, name: str, action: str):
        m = _ACTION_RE.match(action)
        if not m:
            raise ValueError(f"bad fail point action: {action!r}")
        with self._lock:
            self._points[name] = {
                "pct": float(m.group("pct")) if m.group("pct") else None,
                "remaining": int(m.group("cnt")) if m.group("cnt") else None,
                "verb": m.group("verb"),
                "arg": m.group("arg"),
            }
            self._active = sum(1 for p in self._points.values()
                               if p["verb"] != "off")
        from . import events

        if m.group("verb") == "off":
            events.emit("failpoint.disarm", point=name)
        else:
            events.emit("failpoint.arm", severity="warn", point=name,
                        action=action)

    def evaluate(self, name: str):
        """None = not triggered; otherwise the (verb, arg) tuple. Pure:
        sleep/raise act in fail_point(), outside the registry lock."""
        if not self._enabled or not self._active:
            return None
        with self._lock:
            p = self._points.get(name)
            if p is None or p["verb"] == "off":
                return None
            if p["pct"] is not None and self._rng.uniform(0, 100) >= p["pct"]:
                return None
            if p["remaining"] is not None:
                if p["remaining"] <= 0:
                    return None
                p["remaining"] -= 1
            return (p["verb"], p["arg"])


_REGISTRY = _FailPointRegistry()
setup = _REGISTRY.setup
teardown = _REGISTRY.teardown
cfg = _REGISTRY.cfg
arm = _REGISTRY.arm


def fail_point(name: str):
    """FAIL_POINT_INJECT_F analogue: None when not armed or not
    triggered; 'sleep(ms)' blocks then continues, 'raise(msg)' raises
    FailPointError; otherwise the ("return"|"print", arg) tuple, and the
    call site decides what an injected return means."""
    fp = _REGISTRY.evaluate(name)
    if fp is None:
        return None
    verb, arg = fp
    if verb == "sleep":
        time.sleep(float(arg or 0) / 1000.0)
        return None
    if verb == "raise":
        raise FailPointError(arg or f"injected failure at {name}")
    return fp


def inject(name: str) -> None:
    """Stage-boundary hook: sleep()/raise() act inside fail_point(); a
    'return' arming is an injected error too (the stage has no value to
    return); 'print' logs and continues."""
    fp = fail_point(name)
    if fp is None:
        return
    verb, arg = fp
    if verb == "print":
        print(f"[fail_point] {name}: print({arg})", flush=True)
        return
    raise FailPointError(arg or f"injected failure at {name}")
