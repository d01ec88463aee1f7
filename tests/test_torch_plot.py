"""The port's FER plot (``sim/plot.py``) and ``cli plot`` against the JAX
package's, on the CPU.

``plot_fer_curves`` on the same points draws, line for line, the same x/y
data, styles and labels as JAX's; ``cli plot`` writes a PNG at a tiny
sweep; with matplotlib hidden the command still prints both reports, then
exits 2 with one line on stderr, and never writes the PNG.
"""

import dataclasses
import sys

import matplotlib
import numpy as np
import pytest

from ldpc_erasure_codes_tpu.sim import driver as jdriver
from ldpc_erasure_codes_tpu.sim.plot import plot_fer_curves as jax_plot_fer_curves
from ldpc_erasure_codes_tpu_torch.sim import FERPoint
from ldpc_erasure_codes_tpu_torch.sim.plot import plot_fer_curves
from ldpc_erasure_codes_tpu_torch.utils import cli

TINY = ["plot", "--code", "n2040_k1530", "--batch", "64", "--steps-per-call", "1",
        "--max-frames", "64", "--pers", "0.18,0.2", "--device", "cpu"]


def _points(seed):
    rng = np.random.default_rng(seed)
    out = []
    for per in (0.1406, 0.1562, 0.1719, 0.1875, 0.2031):
        errs = int(rng.integers(0, 50))
        out.append(dict(per=per, frames=4096, block_errors=errs, rs_block_errors=errs + 3,
                        fer=errs / 4096, rs_fer=(errs + 3) / 4096, measured_per=per,
                        mean_iters=12.5, ml_failed=0, seconds=1.0, frames_per_sec=4096.0,
                        info_gbps=0.01))
    out[0]["fer"] = 0.0  # clipped to 1e-12 on the log axis
    return out


def _lines(fig):
    ax = fig.axes[0]
    return ([(ln.get_xdata(), ln.get_ydata(), ln.get_linestyle(), ln.get_marker(),
              ln.get_label()) for ln in ax.lines],
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.get_yscale())


@pytest.mark.parametrize("rs", [None, (255, 192)])
def test_plot_lines_match_jax(rs):
    import matplotlib.pyplot as plt

    main, extra = _points(0), _points(1)
    ours = plot_fer_curves([FERPoint(**p, escalations=0) for p in main], title="t",
                           rs_analytic=rs,
                           extra_series={"hybrid": [FERPoint(**p, escalations=0) for p in extra]})
    ref = jax_plot_fer_curves([jdriver.FERPoint(**p) for p in main], title="t", rs_analytic=rs,
                              extra_series={"hybrid": [jdriver.FERPoint(**p) for p in extra]})
    try:
        got, want = _lines(ours), _lines(ref)
        assert got[1:] == want[1:]
        assert len(got[0]) == len(want[0]) == (3 if rs else 2)
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(np.asarray(g[0], float), np.asarray(w[0], float))
            np.testing.assert_array_equal(np.asarray(g[1], float), np.asarray(w[1], float))
            assert g[2:] == w[2:]
    finally:
        plt.close(ours)
        plt.close(ref)


def test_plot_writes_png(tmp_path):
    out = tmp_path / "f.png"
    pts = [FERPoint(**p, escalations=0) for p in _points(2)]
    assert plot_fer_curves(pts, out_path=out) is None
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert dataclasses.fields(FERPoint)[-1].name == "escalations"


def test_cli_plot_writes_png(tmp_path, capsys):
    out = tmp_path / "curve.png"
    assert cli.main(TINY + ["--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "n2040_k1530 MPA" in text and "n2040_k1530 hybrid" in text
    assert f"wrote {out}" in text
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_plot_without_matplotlib_exits_2(tmp_path, capsys, monkeypatch):
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "curve.png"
    assert cli.main(TINY + ["--out", str(out)]) == 2
    cap = capsys.readouterr()
    assert "n2040_k1530 MPA" in cap.out and "n2040_k1530 hybrid" in cap.out
    assert "wrote" not in cap.out
    assert cap.err.strip() == f"plot: matplotlib is not installed, so {out} was not written"
    assert not out.exists()
    assert matplotlib is not None  # the real module is back after the test


def test_cli_plot_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["plot", "--max-frames", "64"])
