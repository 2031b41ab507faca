"""The port's serve entry point against the JAX package's, on the CPU: the
registry lines each prints (its backend, completions and psyncs, and the
completions still registered after ``--crash``) are the same, for the
default backend and for each backend named."""
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
