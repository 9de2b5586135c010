"""Plot the 1-D example: cost-map contours + per-iteration (mu, sigma^2) path.

Script equivalent of the reference's scripts/plot1dexample.ipynb (4 cells:
cost-map heat map, iterate path, cost curve).  Usage:

    python -m gaussianvi_tpu.examples.plot_1d [out.png]
"""

from __future__ import annotations

import sys

import numpy as np


def main(out_path: str = "barfoot_1d.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils.recorder import cost_map_1d
    from .barfoot_1d import build_barfoot_1d, run_barfoot_1d

    graph, _, _ = build_barfoot_1d()
    nmesh = 40
    x_start, x_end, y_start, y_end = 18.0, 25.0, 0.05, 1.0
    z = cost_map_1d(
        graph, x_start=x_start, x_end=x_end,
        y_start=y_start, y_end=y_end, nmesh=nmesh,
    )
    xs = np.linspace(x_start, x_end, nmesh)
    ys = np.linspace(y_start, y_end, nmesh)

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    cs = axes[0].contourf(xs, ys, z, levels=30, cmap="viridis")
    fig.colorbar(cs, ax=axes[0])
    for method, color in (("ngd", "w"), ("prox", "r")):
        _, hist = run_barfoot_1d(method)
        mus = np.asarray(hist.mu[:, 0, 0])
        precs = 1.0 / np.asarray(hist.cov_diag[:, 0, 0, 0])
        axes[0].plot(mus, precs, f"{color}.-", label=method.upper())
        axes[1].plot(np.asarray(hist.cost), ".-", label=method.upper())
    axes[0].set_xlabel(r"$\mu$")
    axes[0].set_ylabel(r"$\Lambda$ (precision)")
    axes[0].set_title("V(q) landscape + iterates")
    axes[0].legend()
    axes[1].set_xlabel("iteration")
    axes[1].set_ylabel("cost")
    axes[1].set_title("convergence")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    print(f"saved {out_path}")


if __name__ == "__main__":
    import jax

    from ..utils.compile_cache import configure_compile_cache

    jax.config.update("jax_enable_x64", True)  # the chain runs in float64
    configure_compile_cache()
    main(*sys.argv[1:2])
