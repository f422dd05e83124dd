"""The paper's §III experiment script (``examples/fedscalar_digits_torch.py``), on the CPU.

The port's script writes the reference script's curves
(``examples/fedscalar_digits.py``): the same CSV header and file names
(``{method}{suffix}.csv``), one row a round.  Its batch draws are the
port's own, so loss and accuracy differ from the reference's; the
modeled columns (cumulative bits, wall-clock and energy) come from the
cost model's ``np.random.RandomState`` alone and equal the reference's
``run_simulation`` for the same seed, to the bit.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import load_digits, make_client_datasets, train_test_split_arrays  # noqa: E402
from repro.fed import SimulationConfig, run_simulation  # noqa: E402
from repro.fed.costmodel import ChannelConfig  # noqa: E402
from repro.models.mlp_classifier import init_mlp  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
COST_KEYS = ("cum_bits", "cum_wall_s", "cum_energy_j")


def _script():
    spec = importlib.util.spec_from_file_location(
        "fedscalar_digits_torch", REPO / "examples" / "fedscalar_digits_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method,extra,suffix", [
    ("fedscalar_rademacher", [], ""),
    ("qsgd", ["--access", "tdma", "--partition", "dirichlet", "--alpha", "0.3"],
     "_dirichlet0.3_tdma"),
])
def test_digits_script_writes_the_reference_curves(tmp_path, capsys, method, extra,
                                                   suffix):
    _script().main(["--rounds", "3", "--runs", "1", "--methods", method,
                    "--outdir", str(tmp_path), "--device", "cpu", *extra])
    path = tmp_path / f"{method}{suffix}.csv"
    lines = path.read_text().splitlines()
    ref_header = (REPO / "experiments" / "digits" / "qsgd.csv").read_text()
    assert lines[0] == ref_header.splitlines()[0]
    got = np.loadtxt(path, delimiter=",", skiprows=1)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got[:, 0], [1, 2, 3])
    assert np.isfinite(got).all()

    access = "tdma" if "tdma" in extra else "concurrent"
    scheme, alpha = ("dirichlet", 0.3) if "dirichlet" in extra else ("iid", 0.5)
    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20, scheme=scheme, alpha=alpha)
    ref = run_simulation(SimulationConfig(method=method, rounds=3, seed=0,
                                          channel=ChannelConfig(access=access)),
                         init_mlp(seed=0), clients, xte, yte)
    for col, key in zip((3, 4, 5), COST_KEYS):
        np.testing.assert_array_equal(got[:, col], np.asarray(ref[key], np.float64),
                                      err_msg=key)
    out = capsys.readouterr().out
    for headline in ("Fig 4 headline", "Fig 5 headline", "Fig 6 headline",
                     "model d = 1990"):
        assert headline in out
