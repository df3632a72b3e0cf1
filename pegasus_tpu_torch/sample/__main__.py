"""Minimal client usage (the reference's src/sample/main.cpp role); the
port of pegasus_tpu/sample/__main__.py, printing the same lines:

    python -m pegasus_tpu_torch.sample <meta host:port> <table>
"""

import sys

from ..client import get_client


def main():
    meta, table = sys.argv[1], sys.argv[2]
    client = get_client(meta, table)

    client.set(b"pegasus", b"cloud", b"engine")
    value = client.get(b"pegasus", b"cloud")
    print(f"get(pegasus, cloud) -> {value!r}")

    client.multi_set(b"fruits", {b"apple": b"red", b"banana": b"yellow"})
    complete, kvs = client.multi_get(b"fruits")
    print(f"multi_get(fruits) -> {kvs}")

    print(f"incr(counter) -> {client.incr(b'stats', b'counter', 1)}")

    for hk, sk, v in client.get_scanner(b"fruits"):
        print(f"scan: {sk!r} = {v!r}")

    client.delete(b"pegasus", b"cloud")
    print(f"after del: {client.get(b'pegasus', b'cloud')!r}")


main()
