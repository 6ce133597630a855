"""Training-curve plotting: a copy of ``sap3d_tpu/train/plotting.py``.

The 4-pane figure (loss / CC / SIM / AUC-Judd against the step) is read back
from the trainer's ``metrics.jsonl``, so it can be made again at any time
(``python -m sap3d_tpu_torch.train.plotting <logs_dir>``).  matplotlib is
optional: without it nothing is drawn.
"""

from __future__ import annotations

import json
import os
import sys


def load_metrics(logs_dir: str) -> list[dict]:
    path = os.path.join(logs_dir, "metrics.jsonl")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    return records


def plot_curves(logs_dir: str, out_path: str | None = None) -> str | None:
    """Write the 4-pane loss/CC/SIM/AUC figure; returns the path written."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None

    records = load_metrics(logs_dir)
    loss = [(r["step"], r["loss"]) for r in records if "loss" in r]
    cc = [(r["step"], r["cc"]) for r in records if "cc" in r]
    sim = [(r["step"], r["sim"]) for r in records if "sim" in r]
    auc = [(r["step"], r["auc_judd"]) for r in records if "auc_judd" in r]

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    panes = [
        (axes[0, 0], loss, "loss"),
        (axes[0, 1], cc, "CC"),
        (axes[1, 0], sim, "SIM"),
        (axes[1, 1], auc, "AUC-Judd"),
    ]
    for ax, series, title in panes:
        if series:
            xs, ys = zip(*series)
            ax.plot(xs, ys)
        ax.set_title(title)
        ax.set_xlabel("step")
    fig.tight_layout()
    out_path = out_path or os.path.join(logs_dir, "curves.png")
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


if __name__ == "__main__":
    print(plot_curves(sys.argv[1]))
