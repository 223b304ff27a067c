"""Loss/accuracy curves.

Counterpart of ``plot_loss_acc`` in ``simclr_tpu/utils/visualizations.py``
(reference: visualizations.py:222-242). Matplotlib is imported inside the
function, so training never pays for it and runs where it is missing
(``pretrain(save_plots=False)``).
"""

from __future__ import annotations

import os
from typing import Sequence


def plot_loss_acc(
    loss: Sequence[float],
    accuracy: Sequence[float],
    title: str = "loss_acc",
    save_plot: bool = False,
    save_dir: str = "results",
):
    """Twin-axis loss/accuracy curves over epochs; with ``save_plot`` the
    figure goes to ``<save_dir>/<title>.png`` and is closed. Returns the
    figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(loss, color="tab:red", label="loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss", color="tab:red")
    ax2 = ax1.twinx()
    ax2.plot(accuracy, color="tab:blue", label="accuracy")
    ax2.set_ylabel("accuracy (%)", color="tab:blue")
    fig.suptitle(title)
    if save_plot:
        os.makedirs(os.path.abspath(save_dir), exist_ok=True)
        fig.savefig(os.path.join(save_dir, f"{title}.png"),
                    bbox_inches="tight", dpi=150)
        plt.close(fig)
    return fig
