"""The port's snapshot sinks and provenance block (``repro_torch.obs.sinks``
and ``repro_torch.obs.meta``) held against ``repro.obs`` on the CPU: the
same snapshots give the same JSON lines, tensors included, and the
provenance guard passes and fails on the same payloads."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as JO  # noqa: E402
from repro.obs import meta as JM  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch.obs import meta as TM  # noqa: E402

PKGS = {"jax": JO, "torch": TO}


def _emit_trail(obs, path, collector):
    """test_obs.py::test_sinks_receive_emitted_snapshots's trail, with a
    gauge, a histogram and a collector added."""
    mem = obs.InMemorySink()
    jl = obs.JSONLSink(str(path))
    assert isinstance(mem, obs.Sink) and isinstance(jl, obs.Sink)
    m = obs.MetricsRegistry(sinks=[mem, jl])
    m.counter("n").inc(np.int64(2))                # numpy scalars coerce
    m.gauge("backlog").set(np.float32(3.5))
    m.histogram("span.ack").record_many(np.array([1e-4, 2e-3, 5e-2]))
    m.register_collector("registry", collector)
    m.emit(label="round-1")
    m.emit()
    jl.close()
    with pytest.raises(ValueError):
        jl.write({})
    return mem.records, path.read_text()


def test_sink_lines_equal_the_jax_sinks(tmp_path):
    """The port's lines equal the JAX package's for the same snapshots;
    the port's collector hands tensors where the JAX one hands numpy."""
    jrec, jtext = _emit_trail(JO, tmp_path / "jax.jsonl", lambda: {
        "hist": np.array([3, 0, 1], np.int32), "psyncs": np.int32(7),
        "overflowed": np.bool_(False)})
    trec, ttext = _emit_trail(TO, tmp_path / "torch.jsonl", lambda: {
        "hist": torch.tensor([3, 0, 1], dtype=torch.int32),
        "psyncs": torch.tensor(7, dtype=torch.int32),
        "overflowed": np.bool_(False)})
    assert ttext == jtext
    lines = [json.loads(line) for line in ttext.splitlines()]
    assert len(lines) == 2 == len(trec) == len(jrec)
    assert lines[0]["label"] == "round-1" and "label" not in lines[1]
    assert lines[0]["counters"]["n"] == 2
    assert lines[0]["collected"]["registry"] == {
        "hist": [3, 0, 1], "psyncs": 7, "overflowed": False}


def test_jsonl_sink_appends(tmp_path):
    path = tmp_path / "trail.jsonl"
    for _ in range(2):
        s = TO.JSONLSink(str(path))
        s.write({"x": torch.arange(3)})
        s.close()
        s.close()                                  # idempotent
    assert path.read_text().splitlines() == ['{"x": [0, 1, 2]}'] * 2


def test_validate_meta_passes_and_fails_as_the_jax_guard():
    good = {"meta": TM.bench_meta()}
    cases = [good, {}, {"meta": {"schema_version": 2}},
             {"meta": {"git_commit": "x"}}]
    got = [TM.validate_meta(c, "p.json") for c in cases]
    want = [JM.validate_meta(c, "p.json") for c in cases]
    assert [len(g) for g in got] == [len(w) for w in want] == [0, 1, 1, 1]
    assert "no meta block" in got[1][0]
    assert "schema_version=2" in got[2][0]
    assert TM.SCHEMA_VERSION == JM.SCHEMA_VERSION


def test_bench_meta_stamps_the_torch_stack():
    meta = TO.bench_meta()
    assert meta["torch_version"] == torch.__version__
    assert meta["cuda_version"] == torch.version.cuda
    assert meta["schema_version"] == JM.SCHEMA_VERSION
    assert isinstance(meta["git_commit"], str) and meta["git_commit"]
    if not torch.cuda.is_available():
        assert meta["device_name"] is None and meta["power_limit"] is None
    assert "jax_version" not in meta


def test_obs_exports_every_name_of_the_jax_package():
    assert set(TO.__all__) == set(JO.__all__)
    for name in TO.__all__:
        assert hasattr(TO, name)


def test_registry_snapshots_while_threads_create_metrics():
    """A ``Snapshotter``'s build thread creates metrics while the main
    thread snapshots the registry: every snapshot completes, and no
    metric is lost."""
    import sys
    import threading
    m = TO.MetricsRegistry()
    n = 300

    def create(k):
        for i in range(n):
            m.histogram(f"span.t{k}.{i}").record(1e-3)
            m.counter(f"t{k}.{i}").inc()
            m.gauge(f"t{k}.{i}").set(1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=create, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            m.snapshot()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    snap = m.snapshot()
    assert [len(snap[k]) for k in ("histograms", "counters", "gauges")] == \
        [4 * n] * 3
