"""Plot train/val mAP learning curves from engine logs.

    python -m skghoi_torch.tools.learning_curve train.log [--output curve.png]

Mirrors ``skghoi_tpu.tools.learning_curve`` (reference
``diagnosis/learning_curve.py:25-55``): parses the ``Epoch: ...`` stdout
lines of :class:`~skghoi_torch.train.engine.LearningEngine` (the same format
as the JAX engine's) and prints and plots the curves.  Host only;
matplotlib is imported only by :func:`plot_curves`, the drawing step.
"""

from __future__ import annotations

import argparse
import re
from typing import List, Tuple


EPOCH_RE = re.compile(
    r"Epoch: (\d+) \| training mAP: ([0-9.]+).*validation mAP: ([0-9.]+)"
)


def parse_log(path: str) -> Tuple[List[int], List[float], List[float]]:
    epochs, train, val = [], [], []
    with open(path, "r") as f:
        for line in f:
            m = EPOCH_RE.search(line)
            if m:
                epochs.append(int(m.group(1)))
                train.append(float(m.group(2)))
                val.append(float(m.group(3)))
    return epochs, train, val


def plot_curves(epochs, train, val, output: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    ax.plot(epochs, train, label="train mAP")
    ax.plot(epochs, val, label="val mAP")
    ax.set_xlabel("epoch")
    ax.set_ylabel("mAP")
    ax.legend()
    fig.savefig(output, dpi=120)
    plt.close(fig)
    print("Saved", output)


def main(argv=None):
    p = argparse.ArgumentParser(description="Plot learning curves from a training log")
    p.add_argument("log", help="training stdout log file")
    p.add_argument("--output", default="learning_curve.png")
    args = p.parse_args(argv)

    epochs, train, val = parse_log(args.log)
    if not epochs:
        print("No 'Epoch:' lines found in", args.log)
        return
    for e, t, v in zip(epochs, train, val):
        print(f"epoch {e}: train mAP {t:.4f} | val mAP {v:.4f}")
    plot_curves(epochs, train, val, args.output)


if __name__ == "__main__":
    main()
