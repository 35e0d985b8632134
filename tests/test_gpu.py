"""Checks that need the GPU: the fused kernel as compiled for the card.

They skip elsewhere.  On a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import jax
import pytest


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is %r)" % jax.default_backend())


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu):
    """The compiled kernel, reached through the library's own dispatch,
    against the float64 reference at the four (K, D) widths of chip_smoke."""
    import chip_smoke

    results = chip_smoke.check_kernel(n=1 << 16, n_rho=1 << 16, n_ref=1 << 12)
    assert all(err_q <= 1.0 and err_rho <= 1.0 for _, _, err_q, err_rho in results), results


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_refuses_cpu(monkeypatch, capsys, argv):
    """Without a GPU chip_smoke exits non-zero and prints no result line; it
    never falls back to the CPU."""
    import chip_smoke

    monkeypatch.setattr("sys.argv", ["chip_smoke.py"] + argv)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert "samples/s" not in capsys.readouterr().out


def test_kernel_ab_refuses_cpu(monkeypatch):
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    path = root / "benchmarks" / "mixture_kernel_ab.py"
    spec = importlib.util.spec_from_file_location("mixture_kernel_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    monkeypatch.setattr("sys.argv", ["mixture_kernel_ab.py"])
    assert ab.main() != 0
