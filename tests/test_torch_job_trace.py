"""The port's job tracer (pegasus_tpu_torch/runtime/job_trace.py) held to
the JAX package's on the CPU.

The JobTracer's semantics run through both packages' tracers with the
same calls and must give the same records. Then the timelines of the
port's background planes carry the reference's hop names: an engine L0
trigger and a manual compaction (engine.trigger, engine.merge,
engine.install), a learn (learn.prepare, learn.fetch, learn.tail,
learn.digest_proof, learn.swap, and the primary's learn.serve_prepare
note on a stub), and an offload round in both package mixes, the
service's hops stitched into the tenant's timeline origin-tagged. The
job-trace remote command answers the reference's pid-keyed JSON.
"""

import json
import os

import numpy as np
import pytest

import pegasus_tpu.runtime.job_trace as ref_jt
import pegasus_tpu_torch.runtime.job_trace as port_jt
from pegasus_tpu_torch.base.key_schema import generate_key
from pegasus_tpu_torch.engine.db import EngineOptions, LsmEngine
from pegasus_tpu_torch.runtime.job_trace import JOB_TRACER, JobTracer

PACKAGES = {"reference": ref_jt, "port": port_jt}


@pytest.fixture(scope="module", autouse=True)
def _stop_port_threads():
    yield
    from pegasus_tpu_torch.ops.pipeline import stop_pools
    from pegasus_tpu_torch.runtime.tasking import TRACKED

    stop_pools()
    TRACKED.join_all(timeout_s=5.0)


def _strip(rec):
    """A record without its clock- and id-dependent fields."""
    out = {k: v for k, v in rec.items()
           if k not in ("job_id", "ts", "duration_us")}
    out["hops"] = [{k: v for k, v in h.items()
                    if k not in ("ts", "duration_us")} for h in rec["hops"]]
    return out


def _scenario(mod):
    """The same calls on a fresh tracer of one package -> its records."""
    t = mod.JobTracer()
    with t.job("compact", engine="/e", pidx=3) as jid:
        with t.hop("engine.merge", level=1) as attrs:
            attrs["inputs"] = 4
        t.note("engine.trigger", trigger="ceiling")
        with t.job("compact"):
            pass
    sched = t.begin("sched", gpid="1.0")
    t.note("sched.decide", job_id=sched, policy="urgent")
    t.begin("compact", job_id=sched, engine="/e")
    t.finish(sched, input_records=9)
    t.finish(sched)
    t.finish("jnope-1")
    t.note("learn.serve_prepare", job_id="jabc-1", blocks=7)
    stitched = t.begin("compact")
    t.stitch(stitched, [{"name": "offload.svc.merge", "duration_us": 5},
                        {"no_name": 1}, "junk", None], origin="svc:99")
    t.stitch(stitched, None)
    capped = t.begin("duplicate")
    t.MAX_HOPS = 4
    for i in range(7):
        t.note("dup.ship_window", job_id=capped, n=i)
    with pytest.raises(RuntimeError):
        with t.job("learn"):
            raise RuntimeError("boom")
    return [_strip(r) for r in t.jobs(last=50)], jid


def test_tracer_records_equal_the_reference():
    ref, _ = _scenario(ref_jt)
    port, _ = _scenario(port_jt)
    assert port == ref
    kinds = [r["kind"] for r in port]
    assert kinds == ["compact", "sched", "learn", "remote", "compact",
                     "duplicate"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_mint_ids_unique_and_seeded(pkg):
    mod = PACKAGES[pkg]
    a, b = mod.JobTracer(), mod.JobTracer()
    ids = {a.mint() for _ in range(200)}
    assert len(ids) == 200 and all(i.startswith("j") for i in ids)
    assert not ids & {b.mint() for _ in range(200)}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_adopt_restores_and_active_set_is_bounded(pkg):
    t = PACKAGES[pkg].JobTracer()
    with t.job("compact") as outer:
        other = t.begin("sched")
        with t.adopt(other):
            assert t.current() == other
            with t.adopt(None):
                assert t.current() == other
        assert t.current() == outer
    t.MAX_ACTIVE = 8
    ids = [t.begin("sched") for _ in range(12)]
    assert t.find(ids[0]) is None and t.find(ids[-1]) is not None
    t.finish(ids[0])


def test_hop_and_note_without_a_job_are_noops():
    t = JobTracer()
    with t.hop("engine.merge"):
        pass
    t.note("lane.fallback", lane="compact.lane")
    assert t.jobs() == []


# ---------------------------------------------------------- the engine


def _key(i):
    return generate_key(b"hk%04d" % i, b"s")


def _port_engine(path, trigger=2):
    return LsmEngine(str(path), EngineOptions(
        device="cpu", memtable_bytes=1, l0_compaction_trigger=trigger))


def _ref_engine(path, trigger=2):
    from pegasus_tpu.engine import EngineOptions as RefOptions
    from pegasus_tpu.engine.db import LsmEngine as RefEngine

    return RefEngine(str(path), RefOptions(
        backend="cpu", memtable_bytes=1, l0_compaction_trigger=trigger))


def _new_jobs(tracer, before, **attrs):
    return [j for j in tracer.jobs(last=500)
            if j["job_id"] not in before
            and all(j["attrs"].get(k) == v for k, v in attrs.items())]


@pytest.mark.parametrize("depth", ["1", "2"])
def test_l0_trigger_is_one_job_with_the_reference_hops(tmp_path, monkeypatch,
                                                        depth):
    monkeypatch.setenv("PEGASUS_COMPACT_PIPELINE_DEPTH", depth)
    names = {}
    for pkg, make, tracer in (
            ("reference", _ref_engine, ref_jt.JOB_TRACER),
            ("port", _port_engine, JOB_TRACER)):
        eng = make(tmp_path / pkg)
        before = {j["job_id"] for j in tracer.jobs(last=500)}
        for i in range(2):
            eng.put(_key(i), b"v" * 32)
            eng.flush()
        (rec,) = _new_jobs(tracer, before, engine=eng.path)
        assert rec["kind"] == "compact" and rec["status"] == "ok"
        assert rec["attrs"]["input_records"] >= 2
        trig = next(h for h in rec["hops"] if h["name"] == "engine.trigger")
        assert trig["trigger"] == "trigger" and trig["l0_files"] >= 2
        names[pkg] = [h["name"] for h in rec["hops"]]
        eng.close()
    assert names["port"] == names["reference"]
    assert ("engine.install" in names["port"]) == (depth == "2")


def test_port_merge_hop_counts_the_kernel_calls(tmp_path):
    eng = _port_engine(tmp_path / "p", trigger=64)
    for i in range(3):
        eng.put(_key(i), b"v" * 32)
        eng.flush()
    before = {j["job_id"] for j in JOB_TRACER.jobs(last=500)}
    eng.manual_compact()
    (rec,) = _new_jobs(JOB_TRACER, before, engine=eng.path,
                       trigger="manual")
    merge = next(h for h in rec["hops"] if h["name"] == "engine.merge")
    assert merge["where"] == "local" and merge["inputs"] == 3
    # the plain merge on CPU tensors launches no kernel
    assert merge["launches"] == 0
    eng.close()


def test_scrub_is_a_job(tmp_path):
    eng = _port_engine(tmp_path / "s", trigger=64)
    for i in range(2):
        eng.put(_key(i), b"v" * 32)
        eng.flush()
    before = {j["job_id"] for j in JOB_TRACER.jobs(last=500)}
    res = eng.scrub()
    (rec,) = _new_jobs(JOB_TRACER, before, path=eng.path)
    assert rec["kind"] == "engine.scrub"
    assert [h["name"] for h in rec["hops"]] == ["scrub.files",
                                                "scrub.manifest"]
    assert rec["hops"][0]["files"] == res["files"] == 2
    eng.close()


# ----------------------------------------------------------- the learn


def test_learn_is_one_job_with_the_reference_hops(tmp_path):
    from pegasus_tpu_torch.replication import ReplicaGroup
    from pegasus_tpu_torch.rpc import messages as msg
    from pegasus_tpu_torch.rpc.task_codes import RPC_PUT

    g = ReplicaGroup(str(tmp_path / "g"), n=3,
                     options_factory=lambda: EngineOptions(device="cpu"))
    try:
        for i in range(20):
            g.write(RPC_PUT, msg.UpdateRequest(_key(i), b"v%d" % i, 0))
        victim = [n for n in g.alive if n != g.primary][0]
        g.kill(victim)
        for i in range(20, 30):
            g.write(RPC_PUT, msg.UpdateRequest(_key(i), b"v%d" % i, 0))
        before = {j["job_id"] for j in JOB_TRACER.jobs(last=500)}
        g.restart(victim)
    finally:
        g.close()
    (rec,) = [j for j in _new_jobs(JOB_TRACER, before) if j["kind"] == "learn"]
    assert rec["status"] == "ok" and rec["attrs"]["learner"] == victim
    names = [h["name"] for h in rec["hops"]]
    assert names[:3] == ["learn.prepare", "learn.fetch", "learn.tail"]
    assert names[-1] == "learn.swap"
    assert set(names) <= {"learn.prepare", "learn.fetch", "learn.tail",
                          "learn.digest_proof", "learn.swap"}


def test_learn_prepare_carries_the_job_to_the_serving_primary(tmp_path):
    """On a stub the learner's job id rides RPC_LEARN_PREPARE, and the
    primary notes its pin on that job (a remote view, or in one process
    the learn's own timeline)."""
    from tests.test_torch_cluster import Cluster, make_client

    c = Cluster(tmp_path)
    try:
        cl = make_client(c, "jt", partitions=1)
        for i in range(10):
            cl.set(b"h%d" % i, b"s", b"v")
        primary = c.meta._parts[1][0].primary
        learner = next(a for a in c.nodes if a != primary)
        before = {j["job_id"] for j in JOB_TRACER.jobs(last=500)}
        from pegasus_tpu_torch.replication.learn import RemoteLearnSource

        src = RemoteLearnSource(c.nodes[learner].pool, primary, 1, 0)
        with JOB_TRACER.job("learn", gpid="1.0") as jid:
            st = src.prepare_learn_state(have=[])
            src.finish_learn(st["learn_id"])
        rec = JOB_TRACER.find(jid)
        assert "learn.serve_prepare" in [h["name"] for h in rec["hops"]]
        note = next(h for h in rec["hops"]
                    if h["name"] == "learn.serve_prepare")
        assert note["gpid"] == "1.0" and note["blocks"] >= 0
        assert not [j for j in _new_jobs(JOB_TRACER, before)
                    if j["kind"] == "remote"]
        cl.close()
    finally:
        c.stop()


# --------------------------------------------------------- the offload


def _offload_runs():
    from tests.test_torch_offload import _runs

    return _runs(seed=3)


@pytest.mark.parametrize("mix", ["port_tenant_reference_service",
                                 "reference_tenant_port_service",
                                 "port_tenant_port_service"])
def test_offload_round_stitches_across_the_packages(tmp_path, mix):
    from pegasus_tpu.ops.compact import CompactOptions as RefOptions
    from pegasus_tpu.replication import compact_offload as ref_off
    from pegasus_tpu_torch.ops.compact import CompactOptions
    from pegasus_tpu_torch.replication import compact_offload as port_off

    tenant_port = mix.startswith("port_tenant")
    svc_port = mix.endswith("port_service")
    svc = (port_off.CompactOffloadService(str(tmp_path / "svc"),
                                          backend="cuda", device="cpu")
           if svc_port else
           ref_off.CompactOffloadService(str(tmp_path / "svc"),
                                         backend="cpu")).start()
    ref_runs, port_runs = _offload_runs()
    try:
        if tenant_port:
            tracer = JOB_TRACER
            opts = CompactOptions(backend="cpu", now=100, runs_sorted=True)
            with tracer.job("compact", tenant="t") as jid:
                port_off.offload_compact_blocks(port_runs, opts, svc.address,
                                                tenant="t")
        else:
            tracer = ref_jt.JOB_TRACER
            opts = RefOptions(backend="cpu", now=100, runs_sorted=True)
            with tracer.job("compact", tenant="t") as jid:
                ref_off.offload_compact_blocks(ref_runs, opts, svc.address,
                                               tenant="t")
    finally:
        svc.stop()
    rec = tracer.find(jid)
    names = [h["name"] for h in rec["hops"]]
    for want in ("offload.ship", "offload.merge", "offload.fetch",
                 "offload.svc.begin", "offload.svc.load",
                 "offload.svc.merge"):
        assert want in names, (want, names)
    assert names.index("offload.ship") < names.index("offload.svc.merge") \
        < names.index("offload.fetch")
    for h in rec["hops"]:
        if h["name"].startswith("offload.svc."):
            assert h["origin"] == svc.address
    ship = next(h for h in rec["hops"] if h["name"] == "offload.ship")
    assert ship["nbytes"] > 0 and ship["service"] == svc.address
    assert next(h for h in rec["hops"]
                if h["name"] == "offload.svc.merge")["records_in"] > 0


# ------------------------------------------------------ remote command


def test_job_trace_remote_command_matches_the_reference_shape():
    from pegasus_tpu.runtime.remote_command import \
        RemoteCommandService as RefCommands
    from pegasus_tpu_torch.runtime.remote_command import RemoteCommandService

    port, ref = RemoteCommandService(), RefCommands()
    port.register_defaults("replica")
    ref.register_defaults("replica")
    with JOB_TRACER.job("compact", probe="port") as pj:
        JOB_TRACER.note("engine.trigger", trigger="manual")
    with ref_jt.JOB_TRACER.job("compact", probe="port") as rj:
        ref_jt.JOB_TRACER.note("engine.trigger", trigger="manual")
    key = f"pid:{os.getpid()}"
    got = json.loads(port.invoke("job-trace", [pj]))
    want = json.loads(ref.invoke("job-trace", [rj]))
    assert list(got) == list(want) == [key]
    assert [_strip(r) for r in got[key]] == [_strip(r) for r in want[key]]
    listed = json.loads(port.invoke("job-trace", ["500"]))[key]
    assert any(r["job_id"] == pj for r in listed)
    assert json.loads(port.invoke("job-trace", ["jnone-0"])) == {key: []}
    assert np.all([set(r) >= {"job_id", "kind", "ts", "hops", "attrs"}
                   for r in listed])
