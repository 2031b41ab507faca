"""The port's training driver and its helpers against the JAX package:
``repro_torch.data.pipeline`` (batches bit for bit), ``runtime.ft`` (the
cases of ``tests/test_runtime.py``), ``launch.train`` (a crash and a
resume equal to an uninterrupted run bit for bit; a resume from the JAX
driver's checkpoint), and bf16 leaves in the port's checkpoint store
(the JAX store's bytes, both layouts).

The JAX drivers run jitted, at qwen3-32b-smoke (f32), B 2, S 16, 20
steps saved every 5.  Tolerance of the cross-package resume: the grad
norm and loss printed at the last step within 1e-4 relative (they are
printed to 3 and 4 decimals); ``step`` equal; params, m and v within lr x
1e-3 absolute, the step tolerance of ``tests/test_torch_train.py``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.data.pipeline import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.store import tensorstore as jts  # noqa: E402
from repro.store.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.ft import ResilientLoop, StragglerMonitor  # noqa: E402
from repro_torch.store import tensorstore as tts  # noqa: E402
from repro_torch.store.checkpoint import CheckpointManager, _to_numpy  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARGS = ["--steps", "20", "--batch", "2", "--seq", "16", "--save-every", "5"]
LR = 3e-3                        # the drivers' default --lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: its
    operations are tiny, and with several test workers on one host each
    op spread over every core spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data pipeline and fault-tolerance runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (1, 1, 2),
                                                   (7, 3, 4)])
def test_synthetic_tokens_equal_jax_across_seek(seed, shard, num_shards):
    """Batch b of every shard is JAX's bit for bit, in order and after a
    seek backwards and forwards."""
    mine = SyntheticTokens(100, 8, 4, shard=shard, num_shards=num_shards,
                           seed=seed)
    ref = JSyntheticTokens(100, 8, 4, shard=shard, num_shards=num_shards,
                           seed=seed)
    for step in (None, None, 9, 2, None, 0):
        if step is not None:
            mine.seek(step)
            ref.seek(step)
        got, want = next(iter(mine)), next(iter(ref))
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert mine.step == ref.step


def test_data_determinism_and_seek():
    a = SyntheticTokens(100, 8, 4, seed=1)
    b1 = next(iter(a))
    a2 = SyntheticTokens(100, 8, 4, seed=1)
    a2.seek(0)
    np.testing.assert_array_equal(b1["tokens"], next(iter(a2))["tokens"])
    s0 = SyntheticTokens(100, 8, 4, shard=0, num_shards=2, seed=1)
    s1 = SyntheticTokens(100, 8, 4, shard=1, num_shards=2, seed=1)
    assert not np.array_equal(next(iter(s0))["tokens"],
                              next(iter(s1))["tokens"])


def test_prefetcher():
    it = iter(SyntheticTokens(100, 8, 2, seed=0))
    limited = (next(it) for _ in range(5))
    assert len(list(Prefetcher(limited, depth=2))) == 5


def test_straggler_monitor():
    m = StragglerMonitor(4, ratio=1.5)
    assert m.stragglers() == []
    for _ in range(10):
        m.record(np.array([1.0, 1.0, 1.0, 3.0]))
    assert m.stragglers() == [3]
    w = m.rebalanced_weights()
    assert w[3] < w[0] and abs(w.sum() - 1) < 1e-9


def test_resilient_loop_crash_restart(tmp_path):
    """An injected failure mid-run: the loop restores the last
    SOFT-committed step of the port's store, reseeks the pipeline and ends
    where a run without failures ends."""
    def run(fail_at, d):
        mgr = CheckpointManager(str(d), keep=3)
        data = SyntheticTokens(50, 4, 2, seed=3)

        def step_fn(state, batch):
            s = state["x"] + float(batch["tokens"].sum() % 97)
            return {"x": s, "step": state["step"] + 1}, {}

        def restore_fn(m, like):
            st = m.latest_step()
            if st is None:
                return None
            arrs = m.restore(st)
            return ({"x": float(arrs["x"]), "step": int(arrs["step"])}, st)

        def snapshot_fn(state):
            return {"x": np.array(state["x"]), "step": np.array(state["step"])}

        loop = ResilientLoop(mgr, data, save_every=4, async_save=False)
        state, steps = loop.run({"x": 0.0, "step": 0}, step_fn, 20,
                                restore_fn, snapshot_fn, fail_at=fail_at)
        mgr.close()
        assert steps == 20
        return state["x"], loop.restarts

    clean, r0 = run(None, tmp_path / "clean")
    crashed, r1 = run(11, tmp_path / "crashed")
    assert clean == crashed and (r0, r1) == (0, 1)


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def _final(d):
    """The arrays of the last committed checkpoint under ``d``."""
    mgr = CheckpointManager(str(d))
    try:
        assert mgr.latest_step() == 20
        return mgr.restore()
    finally:
        mgr.close()


def _last_line(out):
    return [ln for ln in out.splitlines() if ln.startswith("step ")][-1]


def test_train_driver_crash_and_resume_equal_an_uninterrupted_run(
        tmp_path, capsys):
    """``--crash-at 10`` returns 1 after saving step 10; the same command
    resumes there (the pipeline reseeked) and ends at the uninterrupted
    run's final state, bit for bit."""
    common = ARGS + ["--device", "cpu"]
    assert train.main(common + ["--ckpt", str(tmp_path / "a")]) == 0
    clean = capsys.readouterr().out
    crashed = common + ["--ckpt", str(tmp_path / "b")]
    assert train.main(crashed + ["--crash-at", "10"]) == 1
    out = capsys.readouterr().out
    assert "[crash] simulated power failure at step 10" in out
    assert train.main(crashed) == 0
    out = capsys.readouterr().out
    assert out.startswith("[restore] resumed from step 10")
    assert "[done] final checkpoint at step 20" in out
    loss = r"step +20 loss=(\S+) gnorm=(\S+)"
    assert re.search(loss, out).groups() == re.search(loss, clean).groups()
    want, got = _final(tmp_path / "a"), _final(tmp_path / "b")
    assert sorted(got) == sorted(want)
    assert ".opt/.step" in want and ".params/embed/w" in want
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_driver_resumes_the_jax_drivers_checkpoint(tmp_path, capsys):
    """The JAX driver crashes at step 10 with ``--ckpt``; the port's driver
    resumes from that directory to step 20 and ends at the JAX driver's
    uninterrupted 20-step checkpoint."""
    assert jtrain.main(ARGS + ["--ckpt", str(tmp_path / "jax")]) == 0
    want_line = _last_line(capsys.readouterr().out)
    d = str(tmp_path / "both")
    assert jtrain.main(ARGS + ["--ckpt", d, "--crash-at", "10"]) == 1
    capsys.readouterr()
    assert train.main(ARGS + ["--ckpt", d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("[restore] resumed from step 10")
    got_line = _last_line(out)
    pat = r"loss=(\S+) gnorm=(\S+)"
    for g, w in zip(re.search(pat, got_line).groups(),
                    re.search(pat, want_line).groups()):
        assert abs(float(g) - float(w)) <= 1e-4 * abs(float(w)), \
            (got_line, want_line)
    mgr = JManager(str(tmp_path / "jax"))
    want = mgr.restore()
    mgr.close()
    got = _final(d)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = 0 if k == ".opt/.step" else LR * 1e-3
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=0, err_msg=k)


def test_train_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# bf16 leaves in the checkpoint store
# ---------------------------------------------------------------------------

def _bf16_values():
    return np.random.default_rng(0).standard_normal((3, 5)).astype(
        np.float32)


def test_bf16_leaf_is_written_in_the_jax_stores_bytes(tmp_path):
    """A bf16 tensor becomes the same npy bytes as the JAX store writes for
    the same values: the record payload of the ``area`` layout and the
    leaf file of the ``dirs`` layout."""
    vals = _bf16_values()
    jleaf = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    tleaf = torch.from_numpy(vals).to(torch.bfloat16)
    want = jts.encode_array(jleaf)
    assert b"'descr': '<V2'" in want
    assert tts.encode_array(_to_numpy(tleaf)) == want
    for name, mgr in (("jax", JManager(str(tmp_path / "jax"),
                                       layout="dirs")),
                      ("port", CheckpointManager(str(tmp_path / "port"),
                                                 layout="dirs"))):
        mgr.save(1, {"w": jleaf if name == "jax" else tleaf})
        mgr.close()
    path = "step_000000000001/w.npy"
    assert (tmp_path / "port" / path).read_bytes() == \
        (tmp_path / "jax" / path).read_bytes()


@pytest.mark.parametrize("layout", ("area", "dirs"))
def test_bf16_train_state_round_trips(tmp_path, layout):
    """A bf16 ``TrainState`` (bf16 params, f32 and bf16 moments) restores
    bit for bit into its ``like``, async save included; a checkpoint the
    JAX store wrote restores into bf16 tensors too."""
    vals = torch.from_numpy(_bf16_values())
    params = {"w": vals.to(torch.bfloat16), "b": {"s": vals[0]}}
    opt = adamw.AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        m={"w": vals.to(torch.bfloat16) * 3, "b": {"s": vals[1]}},
        v={"w": vals.square().to(torch.bfloat16), "b": {"s": vals[2]}})
    state = TS.TrainState(params, opt)
    mgr = CheckpointManager(str(tmp_path / "port"), layout=layout)
    mgr.save(1, state, async_=True)
    mgr.wait()
    like = TS.TrainState({"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                          "b": {"s": torch.zeros(5)}},
                         adamw.AdamWState(
                             torch.zeros((), dtype=torch.int32),
                             {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                              "b": {"s": torch.zeros(5)}},
                             {"w": torch.zeros(3, 5, dtype=torch.bfloat16),
                              "b": {"s": torch.zeros(5)}}))
    got = mgr.restore(like=like)
    mgr.close()
    assert isinstance(got, TS.TrainState)
    assert isinstance(got.opt, adamw.AdamWState)
    for a, b in ((got.params, params), (got.opt.m, opt.m),
                 (got.opt.v, opt.v)):
        for k in ("w",):
            assert a[k].dtype == torch.bfloat16 and torch.equal(a[k], b[k])
        assert torch.equal(a["b"]["s"], b["b"]["s"])
    assert int(got.opt.step) == 7
    jmgr = JManager(str(tmp_path / "jax"), layout=layout)
    jmgr.save(3, {"w": np.asarray(jnp.asarray(_bf16_values(),
                                              jnp.bfloat16))})
    jmgr.close()
    mgr = CheckpointManager(str(tmp_path / "jax"), layout=layout)
    back = mgr.restore(like={"w": like.params["w"]})
    mgr.close()
    assert torch.equal(back["w"], params["w"])
