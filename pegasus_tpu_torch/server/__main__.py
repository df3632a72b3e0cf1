"""Start the port's server apps from an ini config.

    python -m pegasus_tpu_torch.server --config <ini> [--app <names>]

Starts every [apps.<name>] section that --app selects (comma-separated;
default: every section whose `run` is true, as in pegasus_tpu). The port
serves `type = meta`, `replica`, `collector` and `compact_offload`
(runtime/service_app.py). The onebox is

    python -m pegasus_tpu_torch.server --config onebox.ini

(three metas, three replicas with an http_port on replica1, and the
collector), with the replicas on fixed ports (a node's address is its
identity to the meta). Prints one `[pegasus-tpu] app <name> started
<addr>` line per app, then serves until SIGINT or SIGTERM, and stops
every app before it exits.
"""

import argparse
import signal
import sys
import threading


def _selected(cfg, only):
    """-> [(name, section)] of the apps to start."""
    out = []
    for section in cfg.sections():
        if not section.startswith("apps."):
            continue
        name = section[len("apps."):]
        if only and name not in only:
            continue
        if not cfg.get_bool(section, "run", True):
            continue
        out.append((name, section))
    return out


def main(argv=None) -> int:
    from ..runtime.config import Config
    from ..runtime.service_app import APP_TYPES

    ap = argparse.ArgumentParser(prog="pegasus-tpu-torch-server")
    ap.add_argument("--config", required=True, help="ini config path")
    ap.add_argument("--app", default="", help="comma-separated app names "
                    "(default: every [apps.*] with run=true)")
    ns = ap.parse_args(argv)
    cfg = Config(ns.config)
    only = [a for a in ns.app.split(",") if a] or None
    apps = _selected(cfg, only)
    for name, section in apps:
        type_name = cfg.get_string(section, "type", name)
        if type_name not in APP_TYPES:
            raise ValueError(
                f"app {name!r} has type {type_name!r}: the port serves "
                f"{', '.join(sorted(APP_TYPES))}")
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    started = []
    try:
        for name, section in apps:
            app_type = APP_TYPES[cfg.get_string(section, "type", name)]
            app = app_type(name, cfg, section).start()
            started.append(app)
            print(f"[pegasus-tpu] app {name} started {app.address}",
                  flush=True)
        while not stop.wait(0.5):  # signal handlers run between waits
            pass
    finally:
        for app in reversed(started):
            app.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
