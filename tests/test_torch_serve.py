"""The port's serve entry point against the JAX package's, on the CPU: the
registry lines each prints (its backend, completions and psyncs, and the
completions still registered after ``--crash``) are the same, for the
default backend and for each backend named, with background snapshots of
the registry, with a sharded registry, and with the durable
request/completion spine (``--queue``) in one wave and in pipelined
waves."""
import os
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGS = ["--arch", "qwen3-32b-smoke", "--requests", "2", "--prompt-len", "4",
        "--gen", "2", "--crash"]


def _registry_lines(main, argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    return [line for line in out
            if line.startswith(("registry[", "after crash+recovery"))]


@pytest.mark.parametrize("backend", (None, "probe", "scan", "bucket"))
def test_serve_prints_the_registry_lines_of_jax_serve(backend, capsys):
    argv = ARGS + ([] if backend is None else ["--backend", backend])
    want = _registry_lines(jserve.main, argv, capsys)
    got = _registry_lines(serve.main, ["--device", "cpu"] + argv, capsys)
    assert got == want and len(got) == 2
    assert got[0].startswith(f"registry[{backend or 'probe'}]: 2 completed")


@pytest.mark.parametrize("backend", ("probe", "bucket"))
def test_serve_with_snapshots_prints_the_lines_of_jax_serve(backend, capsys,
                                                           tmp_path):
    """``--snapshot-every 1 --crash``: the same snapshotter, registry and
    recovery lines as the JAX driver -- hybrid recovery through the
    snapshot on the bucket registry, the full-pool fallback on probe."""
    lines = {}
    for name, main in (("jax", jserve.main), ("torch", serve.main)):
        d = tmp_path / name
        argv = ARGS + ["--backend", backend, "--snapshot-every", "1",
                       "--snapshot-dir", str(d)]
        if name == "torch":
            argv = ["--device", "cpu"] + argv
        assert main(argv) == 0
        lines[name] = [line.replace(str(d), "DIR") for line in
                       capsys.readouterr().out.splitlines()
                       if line.startswith(("snapshotter:", "registry[",
                                           "after crash+recovery",
                                           "hybrid recovery:"))]
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 4
    assert lines["torch"][0] == "snapshotter: every 1 step(s) -> DIR"
    restored = {"bucket": "0 delta slot(s) re-scanned, 1024 restored",
                "probe": "1024 delta slot(s) re-scanned, 0 restored"}
    assert restored[backend] in lines["torch"][3]
    # the bucket registry's snapshot was committed and read back
    assert os.listdir(tmp_path / "torch" / "registry") == (
        ["step_000000000001"] if backend == "bucket" else [])


@pytest.mark.parametrize("form", ["separate", "joined"])
@pytest.mark.parametrize("flag", ["--snapshot-every", "--snapshot-dir"])
def test_snapshot_flags_run(flag, form, capsys, tmp_path):
    """The two snapshot options run (they raised NotImplementedError before
    the snapshot store was ported), as ``--flag value`` and as
    ``--flag=value``."""
    value = "1" if flag == "--snapshot-every" else str(tmp_path / "s")
    args = [flag, value] if form == "separate" else [f"{flag}={value}"]
    assert serve.main(["--device", "cpu", *ARGS, "--backend", "bucket",
                       *args]) == 0
    out = capsys.readouterr().out
    assert "after crash+recovery: all 2 completions" in out
    assert ("snapshotter: every 1 step(s)" in out) == \
        (flag == "--snapshot-every")


SHARD_ARGS = ["--arch", "qwen3-32b-smoke", "--requests", "4", "--prompt-len",
              "4", "--gen", "2", "--crash", "--backend", "bucket"]


@pytest.mark.parametrize("extra", [
    [], ["--router", "v1"], ["--placement", "strided"],
    ["--max-lane-budget", "4"], ["--snapshot-every", "1"]],
    ids=["v2", "v1", "strided", "cap", "snapshots"])
def test_serve_shards_prints_the_lines_of_jax_serve(extra, capsys,
                                                    tmp_path):
    """``--shards 4`` with each router, placement, a lane cap and
    background snapshots: the same router, registry, recovery and
    snapshot lines as the JAX driver's."""
    lines = {}
    for name, main in (("jax", jserve.main), ("torch", serve.main)):
        d = tmp_path / name
        argv = SHARD_ARGS + ["--shards", "4", "--snapshot-dir", str(d)] + \
            extra
        if name == "torch":
            argv = ["--device", "cpu"] + argv
        assert main(argv) == 0
        lines[name] = [line.replace(str(d), "DIR") for line in
                       capsys.readouterr().out.splitlines()
                       if line.startswith(("registry", "router:",
                                           "after crash+recovery",
                                           "hybrid recovery:",
                                           "snapshotter:"))]
    assert lines["torch"] == lines["jax"]
    assert "registry[bucket x4 shards]: 4 completed, psyncs=4 " \
        "(== #requests)" in lines["torch"]
    assert "after crash+recovery: all 4 completions still registered" in \
        lines["torch"]
    # v2 prints its route (v1 keeps no stage-1 plan, as in the JAX driver)
    assert any(line.startswith("router: ") and line.endswith("dropped=0")
               for line in lines["torch"]) == ("v1" not in extra)


@pytest.mark.parametrize("kw", [dict(shards=4), dict(shards=4, router="v1"),
                                dict(shards=4, placement="strided",
                                     max_lane_budget=4),
                                dict(shards=4, snapshot_every=1)])
def test_sharded_registry_serves_what_the_flat_one_serves(kw, tmp_path):
    """``run`` with a sharded registry: the same generated tokens, the same
    registry counts (1 psync per completion, every completion after the
    crash, 0 recovery psyncs) as with the flat registry."""
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen3-32b-smoke")
    common = dict(requests=4, prompt_len=4, gen=2, crash=True,
                  backend="bucket", device="cpu")
    flat = serve.run(cfg, **common)
    if "snapshot_every" in kw:
        kw = dict(kw, snapshot_dir=str(tmp_path))
    got = serve.run(cfg, params=flat["params"], **common, **kw)
    assert got["tokens"].equal(flat["tokens"])
    for k in ("registered", "psyncs", "registered_after_recovery",
              "recovery_psyncs", "psyncs_after_recovery"):
        assert got[k] == flat[k], k
    assert (got["registered"], got["psyncs"],
            got["registered_after_recovery"], got["recovery_psyncs"]) == \
        (4, 4, 4, 0)


SMALL = ["--arch", "qwen3-32b-smoke", "--requests", "4", "--prompt-len",
         "4", "--gen", "2"]


@pytest.mark.parametrize("argv", [
    ["--pipeline", "2"], ["--pipeline=3"], ["--queue"],
    ["--queue-capacity", "64"], ["--queue-capacity=64"],
    ["--queue", "--queue-capacity=256"], ["--queue", "--pipeline", "2"],
    ["--queue", "--pipeline=4", "--queue-capacity", "128"],
    ["--pipeline", "1"], ["--queue", "--crash", "--pipeline", "2"]])
def test_spine_and_pipeline_options_run(argv, capsys):
    """The options that waited for the queue and the pipelined waves run
    with ``--shards 4``, as ``--flag value`` and as ``--flag=value`` and
    together (they raised NotImplementedError before), and ``--pipeline``
    above 1 with one shard fails with the JAX driver's usage error."""
    depth = next((int(a.split("=")[1]) for a in argv
                  if a.startswith("--pipeline=")), None)
    if "--pipeline" in argv:
        depth = int(argv[argv.index("--pipeline") + 1])
    waves = depth is not None and depth > 1
    queue = "--queue" in argv
    assert serve.main(["--device", "cpu", "--shards", "4", *SMALL,
                       *argv]) == 0
    out = capsys.readouterr().out
    assert "registry[probe x4 shards]: 4 completed, psyncs=4" in out
    assert ("waves (depth-" in out) == waves
    assert ("spine: acknowledged 4" in out) == (queue and not waves)
    assert ("total spine psyncs=12" in out) == queue
    if waves:
        errs = []
        for main in (jserve.main, serve.main):
            with pytest.raises(SystemExit) as e:
                main(["--shards", "1", *SMALL, *argv])
            assert e.value.code == 2
            errs.append(capsys.readouterr().err.splitlines()[-1])
        assert errs[0] == errs[1]
        assert errs[1].endswith("--pipeline > 1 requires --shards > 1 (the "
                                "pipelined dispatch path lives in the "
                                "sharded registry router)")


SPINE_LINES = ("spine:", "spine after crash+recovery", "served ",
               "registry", "router:", "after crash+recovery",
               "hybrid recovery:", "snapshotter:")


def _mask_times(line):
    """A ``served`` line without its wall time and rate."""
    return re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)$", " in Ts", line)


@pytest.mark.parametrize("extra", [
    ["--queue", "--crash"],
    ["--queue", "--backend", "bucket", "--snapshot-every", "1", "--crash"],
    ["--shards", "4", "--pipeline", "2", "--queue", "--crash"]],
    ids=["queue", "queue-bucket-snapshots", "shards-pipeline-queue"])
def test_serve_spine_prints_the_lines_of_jax_serve(extra, capsys, tmp_path):
    """``--queue`` (with snapshots of all three structures, and with
    pipelined waves over 4 shards): the same spine, served, registry,
    router, recovery and snapshot lines as the JAX driver's, wall times
    aside."""
    lines = {}
    for name, main in (("jax", jserve.main), ("torch", serve.main)):
        d = tmp_path / name
        argv = SMALL + ["--snapshot-dir", str(d)] + extra
        if name == "torch":
            argv = ["--device", "cpu"] + argv
        assert main(argv) == 0
        lines[name] = [_mask_times(line.replace(str(d), "DIR")) for line in
                       capsys.readouterr().out.splitlines()
                       if line.startswith(SPINE_LINES)]
    assert lines["torch"] == lines["jax"]
    got = "\n".join(lines["torch"])
    assert "total spine psyncs=12" in got
    assert ("spine after crash+recovery: 4 acked requests redelivered and "
            "committed, 8 completions survive, request queue drained "
            "(len=0); recovery psyncs: registry=0 req_queue=0 "
            "resp_queue=0") in got
    assert ("served 4 requests x 2 tokens in 4 waves (depth-2 registry "
            "pipeline) in Ts") in got or "--pipeline" not in extra
    if "--snapshot-every" in extra:
        assert sorted(os.listdir(tmp_path / "torch")) == [
            "registry", "req_q", "resp_q"]


SPINE_RUN = dict(requests=4, prompt_len=4, gen=2, crash=True, device="cpu")


@pytest.fixture(scope="module")
def plain_run():
    """One serving run without the spine, shared by the spine's cases."""
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen3-32b-smoke")
    return cfg, serve.run(cfg, **SPINE_RUN)


@pytest.mark.parametrize("kw", [dict(), dict(shards=4, pipeline=2),
                                dict(snapshot_every=1, backend="bucket")],
                         ids=["one-wave", "waves", "snapshots"])
def test_run_with_the_spine_serves_what_run_without_it_serves(kw, tmp_path,
                                                              plain_run):
    """``run(queue=True)``: the same tokens as without the spine, 4
    psyncs per request (ack, response, registry, commit), the late acks
    redelivered after the crash, zero recovery psyncs everywhere."""
    cfg, plain = plain_run
    if "snapshot_every" in kw:
        kw = dict(kw, snapshot_dir=str(tmp_path))
    got = serve.run(cfg, params=plain["params"], queue=True, **SPINE_RUN,
                    **kw)
    assert got["tokens"].equal(plain["tokens"])
    assert got["spine_psyncs"] + got["psyncs"] == 4 * 4
    assert got["phase_psyncs"]["ack"] == got["phase_psyncs"]["record"] == \
        got["phase_psyncs"]["commit"] == 4
    assert got["redelivered"] == 4 and got["req_queue_len"] == 0
    assert got["completions_after_recovery"] == 8
    assert got["queue_recovery_psyncs"] == {"req_queue": 0, "resp_queue": 0}
    assert (got["registered_after_recovery"], got["recovery_psyncs"]) == \
        (4, 0)
    assert set(got["phase_ms"]) >= {"ack", "record", "commit"}
    assert got["ack_overlapped"] == []        # no card: nothing measured
