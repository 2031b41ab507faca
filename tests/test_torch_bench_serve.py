"""The port's open-loop serving harness (``repro_torch.launch.bench_serve``)
held against the JAX package's (``repro.launch.bench_serve``) on the CPU.

Both drivers run at a small geometry: a 2^10-slot SOFT probe registry
over 1 or 2 shards, 64-lane batches, spine queues of 128 (and of 32, so
that acks are rejected and commits fall short in both).  The arrival
stream must be equal bit for bit, a padded spine round must leave every
state leaf of the registry and both queues equal, and a short open loop
must give the same payload keys and exact psyncs per queue op.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.obs as JO  # noqa: E402
from repro.launch import bench_serve as JB  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch.core.engine import OP_NOP  # noqa: E402
from repro_torch.launch import bench_serve as TB  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402

SMALL = dict(capacity=1 << 10, batch=64, key_range=5000,
             queue_capacity=128, shards=1)
PKGS = {"jax": (JB, JO, {}), "torch": (TB, TO, {"device": "cpu"})}
# lanes of each round's real requests; the rest of the 64 are OP_NOP
ROUND_FILL = (64, 40, 64, 17, 64, 33)


def _cfg(pkg, **kw):
    mod, _, extra = PKGS[pkg]
    return mod.ServeConfig(**{**SMALL, **extra, **kw})


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_arrival_stream_equal_bit_for_bit_across_refills(seed):
    """Times, keys and op codes of every take, through several refills of
    the 2^14-event chunk."""
    gens = [mod._ArrivalGen(_cfg(pkg, seed=seed), 10_000.0)
            for pkg, (mod, _, _) in PKGS.items()]
    assert [g.next_arrival() for g in gens][0] == gens[1].next_arrival()
    drawn = 0
    for now in np.linspace(0.05, 5.0, 14):
        (jt, jk, jo), (tt, tk, to) = (g.take(float(now), 4096)
                                      for g in gens)
        for a, b in ((jt, tt), (jk, tk), (jo, to)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        drawn += jt.size
    assert drawn > 2 * TB._ArrivalGen.CHUNK        # refilled twice or more


def _leaves(state) -> dict:
    """Host arrays of every leaf of a registry or queue state, either
    package's."""
    return {f: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for f, v in zip(state._fields, state)}


def _drive_rounds(pkg, cfg):
    """The rounds of ``ROUND_FILL`` through the package's spine; returns
    the structures, the registry of metrics and per round the queues'
    (tail, head) cursors and the real-lane count."""
    mod, obs, _ = PKGS[pkg]
    m = obs.MetricsRegistry()
    registry, req_q, resp_q = mod._build_spine(cfg, m)
    gen = mod._ArrivalGen(cfg, 1000.0)
    cursors = []
    for n in ROUND_FILL:
        _, k, o = gen.take(1e9, n)
        keys = np.zeros((cfg.batch,), np.int32)
        ops = np.full((cfg.batch,), OP_NOP, np.int32)
        keys[:n], ops[:n] = k, o
        real = mod._spine_round(m, registry, req_q, resp_q, req_q.spec,
                                keys, ops)
        cursors.append((real,) + tuple(
            int(getattr(q.state, c)) for q in (req_q, resp_q)
            for c in ("tail", "head")))
    return (registry, req_q, resp_q), m, cursors


@pytest.mark.parametrize("shards,qcap", [(1, 128), (2, 128), (1, 32)],
                         ids=["flat", "2-shard", "flat-queue-32"])
def test_spine_round_equal_leaf_for_leaf(shards, qcap):
    """Six padded rounds (OP_NOP lanes bill no psync): every leaf of the
    registry and of both queues, the queues' cursors after each round (the
    ok counts), the spine counters and the collected totals are equal.
    The 32-slot queue rejects acks and falls short on commits in both."""
    runs = {pkg: _drive_rounds(pkg, _cfg(pkg, shards=shards,
                                         queue_capacity=qcap))
            for pkg in PKGS}
    (js, jm, jc), (ts, tm, tc) = runs["jax"], runs["torch"]
    assert jc == tc
    for j, t in zip(js, ts):                 # registry, req_q, resp_q
        jl, tl = _leaves(j.state), _leaves(t.state)
        assert jl.keys() == tl.keys()
        for f in jl:
            assert jl[f].dtype == tl[f].dtype, f
            assert np.array_equal(jl[f], tl[f]), f
    jsnap, tsnap = jm.snapshot(), tm.snapshot()
    assert jsnap["counters"] == tsnap["counters"]
    for name, jcoll in jsnap["collected"].items():
        tcoll = tsnap["collected"][name]
        for k in ("psyncs", "ops", "psync_total", "ops_total", "size",
                  "overflowed", "router_dropped", "pipeline_abandoned"):
            assert jcoll.get(k) == tcoll.get(k), (name, k)
    assert sorted(jsnap["histograms"]) == sorted(tsnap["histograms"])
    rejected = tsnap["counters"].get("spine.ack_rejected", 0)
    short = tsnap["counters"].get("spine.commit_short", 0)
    if qcap == 32:
        assert rejected > 0 and short > 0
    else:
        assert rejected == 0 and short == 0
        # exactly one psync per acked, responded, committed, delivered op
        for q in ts[1:]:
            assert q.psyncs == q.ops == 2 * sum(ROUND_FILL)


def test_percentiles_equal_for_the_same_samples():
    rng = np.random.default_rng(3)
    samples = rng.lognormal(-5.0, 1.5, 5000)
    out = []
    for pkg in PKGS:
        mod, obs, _ = PKGS[pkg]
        h = obs.MetricsRegistry().histogram("serve.latency")
        h.record_many(samples)
        out.append(mod._percentiles_ms(h))
    assert out[0] == out[1]
    empty = [mod._percentiles_ms(obs.MetricsRegistry().histogram("x"))
             for mod, obs, _ in PKGS.values()]
    assert empty[0] == empty[1] and empty[0]["p99_ms"] is None


def _key_tree(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _key_tree(v, prefix + k + ".")
    return out


def test_open_loop_payloads_agree():
    """A 0.3 s open loop at a fixed rate on each package: the same payload
    keys (the port's config adds ``device``; each ``meta`` names its own
    stack), exactly one psync per queue op in both, and the port's
    counters hold the spine's invariants."""
    pay = {pkg: PKGS[pkg][0].run_open_loop(_cfg(pkg, duration=0.3,
                                                rate=2000.0))
           for pkg in PKGS}
    trees = {pkg: {k for k in _key_tree(p) if not k.startswith("meta.")}
             for pkg, p in pay.items()}
    assert trees["torch"] - {"config.device"} == trees["jax"]
    assert set(pay["torch"]["meta"]) == {
        "git_commit", "torch_version", "cuda_version", "device_name",
        "power_limit", "schema_version"}
    assert TO.meta.validate_meta(pay["torch"], "port") == []
    for pkg, p in pay.items():
        assert p["psync_per_op"]["req_queue"] == 1.0, pkg
        assert p["psync_per_op"]["resp_queue"] == 1.0, pkg
    p = pay["torch"]
    c = p["counters"]
    assert (c["ack_rejected"], c["commit_short"], c["router_dropped"],
            c["pipeline_abandoned"]) == (0, 0, 0, 0)
    assert not c["registry_overflowed"] and not c["queue_overflowed"]
    assert p["requests_completed"] > 0
    assert p["latency"]["count"] == p["requests_completed"]
    assert 0 < p["psync_per_op"]["registry"] <= 0.5    # the update share
    assert set(p["spans_ms"]) == {"ack", "dispatch", "commit", "force"}
    assert p["config"]["device"] == "cpu"
    json.dumps(p)


@pytest.mark.parametrize("argv", [
    ["--utilization", "abc"], ["--utilization", ","],
    ["--utilization", "0.5,0.9", "--rate", "10"], ["--backend", "nope"]])
def test_cli_usage_errors_equal(argv, capsys):
    lines = []
    for mod, _, _ in PKGS.values():
        with pytest.raises(SystemExit) as e:
            mod.main(argv + ["--out", "/dev/null"])
        assert e.value.code == 2
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert lines[0] == lines[1]


def test_serve_open_loop_delegates_and_writes_payload(tmp_path, capsys):
    out = tmp_path / "serve.json"
    assert TS.main(["--open-loop", "--device", "cpu", "--duration", "0.2",
                    "--rate", "2000", "--capacity", "1024", "--shards", "1",
                    "--batch", "64", "--queue-capacity", "128",
                    "--key-range", "5000", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[u=0.60] open-loop:" in text and f"wrote {out}" in text
    p = json.loads(out.read_text())
    assert p["config"] == dataclasses.asdict(TB.ServeConfig(
        duration=0.2, rate=2000.0, capacity=1024, shards=1, batch=64,
        queue_capacity=128, key_range=5000, device="cpu"))
    assert p["psync_per_op"]["req_queue"] == 1.0


def test_bench_serve_refuses_a_missing_card():
    """No fallback: without a GPU the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.run_open_loop(TB.ServeConfig(**SMALL, duration=0.1, rate=100.0))
