"""Block service: pluggable remote file store for backup / bulk load.

Port of pegasus_tpu/runtime/block_service.py, whole (the rDSN
block-service surface: reference config.ini [block_service.*],
HDFS/local providers). Cold backup uploads checkpoints to it, restore
reads them back at a replica's open. Providers register by name;
`local_service` ships (the onebox/filesystem provider the reference also
uses for tests); an object-store provider plugs in the same way.
"""

import os
import shutil


class BlockService:
    """Interface: paths are provider-namespace keys (posix-style)."""

    def upload(self, local_path: str, remote_path: str) -> None:
        raise NotImplementedError

    def download(self, remote_path: str, local_path: str) -> None:
        raise NotImplementedError

    def list_dir(self, remote_dir: str) -> list:
        raise NotImplementedError

    def exists(self, remote_path: str) -> bool:
        raise NotImplementedError

    def read(self, remote_path: str) -> bytes:
        raise NotImplementedError

    def write(self, remote_path: str, data: bytes) -> None:
        raise NotImplementedError

    def upload_dir(self, local_dir: str, remote_dir: str) -> int:
        n = 0
        for name in sorted(os.listdir(local_dir)):
            src = os.path.join(local_dir, name)
            if os.path.isfile(src):
                self.upload(src, f"{remote_dir}/{name}")
                n += 1
        return n

    def download_dir(self, remote_dir: str, local_dir: str) -> int:
        os.makedirs(local_dir, exist_ok=True)
        n = 0
        for name in self.list_dir(remote_dir):
            self.download(f"{remote_dir}/{name}", os.path.join(local_dir, name))
            n += 1
        return n


class LocalBlockService(BlockService):
    """Filesystem provider rooted at `root` (the reference's local_service)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _abs(self, remote_path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, remote_path.lstrip("/")))
        if not p.startswith(os.path.abspath(self.root)):
            raise ValueError(f"path escapes block-service root: {remote_path}")
        return p

    def upload(self, local_path: str, remote_path: str) -> None:
        dst = self._abs(remote_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(local_path, dst)

    def download(self, remote_path: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        shutil.copy2(self._abs(remote_path), local_path)

    def list_dir(self, remote_dir: str) -> list:
        d = self._abs(remote_dir)
        if not os.path.isdir(d):
            return []
        return sorted(n for n in os.listdir(d)
                      if os.path.isfile(os.path.join(d, n)))

    def exists(self, remote_path: str) -> bool:
        return os.path.exists(self._abs(remote_path))

    def read(self, remote_path: str) -> bytes:
        with open(self._abs(remote_path), "rb") as f:
            return f.read()

    def write(self, remote_path: str, data: bytes) -> None:
        dst = self._abs(remote_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(data)


_PROVIDERS = {"local_service": LocalBlockService}


def register_provider(name: str, cls) -> None:
    _PROVIDERS[name] = cls


def create_block_service(provider: str, root: str) -> BlockService:
    cls = _PROVIDERS.get(provider)
    if cls is None:
        raise ValueError(f"unknown block service provider {provider!r}")
    return cls(root)
