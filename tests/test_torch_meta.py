"""The port's meta plane (pegasus_tpu_torch.meta) against pegasus_tpu's.

Every meta message and every learn message of the replication wire
encodes to the same bytes in both packages, and each package decodes
the other's; the meta's state.json is read across the packages both
ways; the election redirects on a follower and fails over to it when
the leader steps down.
"""

import dataclasses
import time
import typing

import numpy as np
import pytest

from pegasus_tpu.meta import messages as ref_mm
from pegasus_tpu.meta import meta_server as ref_meta
from pegasus_tpu.rpc import codec as ref_codec
from pegasus_tpu.rpc import messages as ref_msg
from pegasus_tpu_torch.meta import messages as port_mm
from pegasus_tpu_torch.meta import meta_server as port_meta
from pegasus_tpu_torch.meta.election import MetaElection
from pegasus_tpu_torch.rpc import codec as port_codec
from pegasus_tpu_torch.rpc import messages as port_msg
from pegasus_tpu_torch.rpc.transport import ERR_FORWARD_TO_PRIMARY, RpcError
from tests.test_torch_offload import _instance

META_NAMES = sorted(
    n for n, c in vars(ref_mm).items()
    if dataclasses.is_dataclass(c) and c.__module__ == ref_mm.__name__)
LEARN_NAMES = ["LearnBlockEntry", "LearnPrepareRequest",
               "LearnPrepareResponse", "LearnFetchRequest",
               "LearnFetchResponse", "LearnTailRequest", "LearnTailResponse",
               "LearnFinishRequest"]
MESSAGES = ([(getattr(port_mm, n), getattr(ref_mm, n)) for n in META_NAMES]
            + [(getattr(port_msg, n), getattr(ref_msg, n))
               for n in LEARN_NAMES])


def test_every_meta_message_is_ported():
    port_names = {n for n, c in vars(port_mm).items()
                  if dataclasses.is_dataclass(c)}
    assert port_names == set(META_NAMES) and len(META_NAMES) > 60


@pytest.mark.parametrize("port_cls,ref_cls", MESSAGES,
                         ids=[p.__name__ for p, _ in MESSAGES])
def test_message_same_bytes_both_packages(port_cls, ref_cls):
    """Field names, order, types and defaults equal; seeded non-default
    instances encode to the same bytes in both packages, and each
    decodes the other's."""
    pf, rf = dataclasses.fields(port_cls), dataclasses.fields(ref_cls)
    assert [f.name for f in pf] == [f.name for f in rf]
    assert [str(typing.get_type_hints(port_cls)[f.name]) for f in pf] == \
        [str(typing.get_type_hints(ref_cls)[f.name]).replace(
            "pegasus_tpu.", "pegasus_tpu_torch.") for f in rf]
    assert [f.default for f in pf] == [f.default for f in rf]
    assert port_codec.encode(port_cls()) == ref_codec.encode(ref_cls())
    pairs = dict(MESSAGES)
    for seed in range(8):
        port_obj = _instance(port_cls, np.random.default_rng(seed),
                             lambda c: c)
        ref_obj = _instance(port_cls, np.random.default_rng(seed),
                            lambda c: pairs[c])
        wire = port_codec.encode(port_obj)
        assert wire == ref_codec.encode(ref_obj)
        assert dataclasses.asdict(ref_codec.decode(ref_cls, wire)) == \
            dataclasses.asdict(port_obj)
        assert dataclasses.asdict(port_codec.decode(port_cls, wire)) == \
            dataclasses.asdict(ref_obj)


def test_task_codes_match_the_reference():
    from pegasus_tpu.replication import replica_stub as ref_stub
    from pegasus_tpu_torch.replication import replica_stub as port_stub

    for name in dir(ref_meta):
        if name.startswith("RPC_"):
            assert getattr(port_meta, name) == getattr(ref_meta, name)
    for name in ("RPC_PREPARE", "RPC_LEARN", "RPC_LEARN_PREPARE",
                 "RPC_LEARN_FETCH", "RPC_LEARN_TAIL", "RPC_LEARN_FINISH",
                 "RPC_REMOTE_COMMAND"):
        assert getattr(port_stub, name) == getattr(ref_stub, name)


# ------------------------------------------------------------- state file

def _populate(meta, mm, codec, node="127.0.0.1:1"):
    """A meta state through the handlers: one beaconing (unreachable)
    node, two apps, envs, a level; plus the planes the port keeps only as
    data (duplications, policies, a soft drop)."""
    meta._on_beacon(None, codec.encode(mm.BeaconRequest(node=node)))
    for name, n in (("t1", 4), ("t2", 3)):
        r = codec.decode(mm.CreateAppResponse, meta._on_create_app(
            None, codec.encode(mm.CreateAppRequest(name, n, 3,
                                                   '{"a": "1"}'))))
        assert r.error == 0
    meta._on_set_app_envs(None, codec.encode(mm.SetAppEnvsRequest(
        "t1", '{"default_ttl": "60"}')))
    meta._on_drop_app(None, codec.encode(mm.DropAppRequest("t2", 3600)))
    meta._on_control_meta(None, codec.encode(
        mm.ControlMetaRequest(set_level="steady")))
    meta._dups = {1: [{"dupid": 5, "remote": "west", "status": "start"}]}
    meta._policies = {"nightly": {"name": "nightly", "interval": 3600}}
    meta._next_dupid = 6
    meta._persist()


def _state(meta) -> dict:
    return {"apps": {n: vars(a) for n, a in meta._apps.items()},
            "parts": {a: [vars(pc) for pc in ps]
                      for a, ps in meta._parts.items()},
            "dups": meta._dups, "policies": meta._policies,
            "dropped": meta._dropped, "level": meta.level,
            "next": (meta._next_app_id, meta._next_dupid),
            "epoch": meta._state_epoch}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_file_reads_across_packages(tmp_path, writer):
    path = str(tmp_path / "meta" / "state.json")
    if writer == "reference":
        w = ref_meta.MetaServer(path)
        _populate(w, ref_mm, ref_codec)
        r = port_meta.MetaServer(path)
    else:
        w = port_meta.MetaServer(path)
        _populate(w, port_mm, port_codec)
        r = ref_meta.MetaServer(path)
    assert _state(r) == _state(w)
    assert r.level == "steady" and set(r._dropped) == {2}
    # the reader persists it again: the writer's package reads it back
    # unchanged, the planes the port does not serve included
    r._persist()
    again = type(w)(path)
    assert _state(again) == _state(w)


# --------------------------------------------------------------- election

def _elected(tmp_path, addr, lease=0.6):
    path = str(tmp_path / "state.json")
    holder = {}
    el = MetaElection(path + ".lock", addr, lease_seconds=lease,
                      on_acquire=lambda: holder["meta"].reload_state(),
                      claim_floor=lambda: holder["meta"]._read_state_epoch())
    holder["meta"] = port_meta.MetaServer(path, election=el)
    return holder["meta"], el


def test_follower_redirects_and_the_leader_fails_over(tmp_path):
    a, ea = _elected(tmp_path, "127.0.0.1:1")
    b, eb = _elected(tmp_path, "127.0.0.1:2")
    ea.start()
    eb.start()
    try:
        assert ea.is_leader() and not eb.is_leader()
        ha, hb = a.rpc_handlers(), b.rpc_handlers()
        beacon = port_codec.encode(port_mm.BeaconRequest(node="127.0.0.1:3"))
        ha[port_meta.RPC_FD_BEACON](None, beacon)
        hb[port_meta.RPC_FD_BEACON](None, beacon)  # followers absorb beacons
        create = port_codec.encode(port_mm.CreateAppRequest("t", 2, 1))
        assert port_codec.decode(port_mm.CreateAppResponse, ha[
            port_meta.RPC_CM_CREATE_APP](None, create)).error == 0
        with pytest.raises(RpcError) as e:
            hb[port_meta.RPC_CM_CREATE_APP](None, create)
        assert e.value.err == ERR_FORWARD_TO_PRIMARY
        assert "127.0.0.1:1" in e.value.text
        ea.stop()   # the leader steps down; the follower takes over
        deadline = time.monotonic() + 10
        while not eb.is_leader():
            assert time.monotonic() < deadline, "no takeover"
            time.sleep(0.05)
        assert eb.epoch > ea.epoch - 1 and "t" in b._apps
        q = port_codec.decode(port_mm.QueryConfigResponse, hb[
            port_meta.RPC_CM_QUERY_CONFIG](None, port_codec.encode(
                port_mm.QueryConfigRequest("t"))))
        assert q.error == 0 and len(q.partitions) == 2
    finally:
        ea.stop()
        eb.stop()
