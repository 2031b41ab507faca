"""The torch examples (``examples/*_torch.py``) on the CPU, held against
the JAX package's examples: the quickstart and crash-recovery examples
print the same psync, size, recovery-histogram and oracle lines.  Every
line is compared: the adversaries are unseeded, but each crash lands at a
dispatch boundary, where every node is flushed and any adversary leaves
the same state.  The serving example runs the port's serve CLI with the
JAX example's arguments."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ("quickstart", "crash_recovery"))
def test_example_prints_the_jax_examples_lines(name, capsys):
    _load(name).main()
    want = capsys.readouterr().out.splitlines()
    _load(f"{name}_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) > 10
    assert got == want


def test_serve_kv_example_runs_on_the_cpu(capsys):
    assert _load("serve_kv_torch").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "registry[bucket]: 8 completed, psyncs=8 (== #requests)" in out
    assert "after crash+recovery: all 8 completions still registered" in out


def test_examples_default_to_the_card():
    """Without ``--device cpu`` an example asks for the GPU and raises
    where there is none (no fallback)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("quickstart_torch").main([])


def test_train_lm_example_crashes_and_resumes_on_the_cpu(capsys):
    """The training example at 40 steps: the crash at step 20 (after its
    save), the restart from step 20, the final checkpoint at 40.  One
    intra-op thread: the smoke model's operations are tiny, and with
    several test workers on one host each op spread over every core waits
    on the others."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert _load("train_lm_torch").main(
            ["--device", "cpu", "--steps", "40"]) == 0
    finally:
        torch.set_num_threads(n)
    out = capsys.readouterr().out
    assert "[crash] simulated power failure at step 20" in out
    assert "[restore] resumed from step 20" in out
    assert "[done] final checkpoint at step 40" in out
    assert out.rstrip().endswith("crash/restart training round-trip "
                                 "complete.")
