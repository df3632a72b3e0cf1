"""Client factory: one cached client per (cluster, app).

Port of pegasus_tpu/client/factory.py, whole.

Mirror of pegasus_client_factory (src/client_lib/client_factory.cpp +
pegasus_client_factory_impl): get_client returns a process-wide singleton
per (meta list, app name), sharing one connection pool.
"""

import threading

from ..rpc.transport import ConnectionPool
from .client import PegasusClient
from .meta_resolver import MetaResolver

_lock = threading.Lock()
_clients = {}
_pool = ConnectionPool()


def get_client(meta_servers, app_name: str) -> PegasusClient:
    """meta_servers: list or comma-separated string of host:port."""
    if isinstance(meta_servers, str):
        meta_servers = [m for m in meta_servers.split(",") if m]
    key = (tuple(meta_servers), app_name)
    with _lock:
        cli = _clients.get(key)
        if cli is None:
            cli = PegasusClient(MetaResolver(list(meta_servers), app_name,
                                             _pool), pool=_pool)
            _clients[key] = cli
        return cli


def close_all() -> None:
    with _lock:
        _clients.clear()
    _pool.close()
