"""FER curve plotting — the reference's semilogy performance figures.

Counterpart of ``ldpc_erasure_codes_tpu/sim/plot.py`` (:17-73), whole.
Produces the FER-vs-PER comparison plot the MATLAB sims draw
(LDPCErasureCodes_MessagePassingAlgSim.m:249-256 semilogy; shipped figures
Latex/LDPC_triangular_2040_1530_Perf_vs_RS.png etc.), with the analytic
rate-matched RS curve overlaid. Matplotlib is imported lazily so the module
stays importable where it is not installed (``cli plot`` then exits 2
after its sweeps).
"""

from __future__ import annotations

import os
from typing import Sequence

from ldpc_erasure_codes_tpu_torch.sim.driver import FERPoint


def plot_fer_curves(
    points: Sequence[FERPoint],
    *,
    title: str = "",
    rs_analytic: tuple[int, int] | None = None,
    extra_series: dict[str, Sequence[FERPoint]] | None = None,
    out_path: str | os.PathLike | None = None,
):
    """Semilog FER-vs-PER plot.

    Args:
      points: simulated operating points (the main decoder curve).
      rs_analytic: (rs_n, rs_k) to overlay the closed-form MDS RS curve.
      extra_series: optional named additional curves (e.g. "MPA" vs "hybrid").
      out_path: save as PNG when given; otherwise return the figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, ax = plt.subplots(figsize=(7, 5))
    pers = [p.per for p in points]
    fers = [max(p.fer, 1e-12) for p in points]
    ax.semilogy(pers, fers, "o-", label="LDPC (simulated)")
    if extra_series:
        for name, pts in extra_series.items():
            ax.semilogy(
                [p.per for p in pts],
                [max(p.fer, 1e-12) for p in pts],
                "s--",
                label=name,
            )
    if rs_analytic is not None:
        from ldpc_erasure_codes_tpu_torch.rs import analytic_rs_fer

        rn, rk = rs_analytic
        xs = np.linspace(min(pers), max(pers), 64)
        ax.semilogy(
            xs,
            [max(analytic_rs_fer(rn, rk, float(x)), 1e-12) for x in xs],
            "-",
            label=f"RS({rn},{rk}) analytic (per block)",
        )
    ax.set_xlabel("raw packet erasure rate")
    ax.set_ylabel("block error rate")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
