"""Server roles the port's entry point (server/__main__.py) can start.

Port of pegasus_tpu/runtime/service_app.py's CompactOffloadApp: the
compaction-offload service as a server app. The meta, replica and
collector roles come with the serving chain (ROADMAP Queue 1 item 6).
"""

import os

from ..replication.compact_offload import CompactOffloadService
from .config import Config


class CompactOffloadApp:
    """One card-owning compaction service per GPU host, serving many
    cpu-only replica nodes. Config:

        [apps.offload]
        type = compact_offload
        port = 34901            ; what nodes' placement leases dial
        backend = cuda          ; cuda | cpu; default: [pegasus.server]
                                ; compaction_backend, else cuda
        device = cuda:0         ; the card to merge on (default: cuda)
        job_dir = ...           ; staged-run + job spool (default per-app)
    """

    def __init__(self, name, config: Config, section: str):
        backend = config.get_string(
            section, "backend",
            config.get_string("pegasus.server", "compaction_backend", "cuda"))
        root = config.get_string(section, "job_dir",
                                 os.path.join("pegasus-data", name))
        self.svc = CompactOffloadService(
            root,
            host=config.get_string(section, "host", "127.0.0.1"),
            port=config.get_int(section, "port", 0),
            backend=backend,
            device=config.get_string(section, "device", None))

    @property
    def address(self):
        return self.svc.address

    def start(self):
        self.svc.start()
        print(f"[pegasus-tpu] compaction offload service on "
              f"{self.svc.address} (backend {self.svc.backend})", flush=True)
        return self

    def stop(self):
        self.svc.stop()
