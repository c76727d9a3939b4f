"""Visualise cached .mat results: per-class PR curves and ranked scores.

    python -m skghoi_torch.tools.visualise_and_cache --cache-dir matlab_cache --object 3

Mirrors ``skghoi_tpu.tools.visualise_and_cache`` (reference
``diagnosis/visualise_and_cache.py:30-65``): reads the ``detections_XX.mat``
caches that :mod:`skghoi_torch.tools.cache_results` writes and plots
precision-recall + sorted-score curves for a chosen interaction class of a
chosen object.  Host only: :func:`ranked_scores` computes, :func:`plot_scores`
draws (the only place matplotlib is imported).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy import io as sio


def ranked_scores(cache_dir: str, obj: int, row: int):
    """``(path, scores)``: the ``.mat`` file of object ``obj`` and the
    scores of every detection of its interaction ``row``, highest first."""
    path = os.path.join(cache_dir, f"detections_{str(obj).zfill(2)}.mat")
    all_boxes = sio.loadmat(path)["all_boxes"]
    rows = all_boxes[row]
    scores = np.concatenate(
        [r[:, 8] for r in rows.ravel() if getattr(r, "size", 0) > 0] or [np.zeros(0)]
    )
    return path, scores[np.argsort(-scores)]


def plot_scores(scores: np.ndarray, num_gt, output: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(scores)
    axes[0].set_title("ranked scores")
    if num_gt:
        # Without association labels only the score curve is exact; show the
        # optimistic PR upper bound (every detection a TP).
        tp = np.arange(1, len(scores) + 1)
        axes[1].plot(tp / num_gt, tp / tp)
        axes[1].set_title("PR upper bound")
    fig.savefig(output, dpi=120)
    plt.close(fig)
    print("Saved", output)


def main(argv=None):
    p = argparse.ArgumentParser(description="PR curves from cached .mat results")
    p.add_argument("--cache-dir", default="matlab_cache")
    p.add_argument("--object", default=0, type=int, help="COCO object class id")
    p.add_argument("--row", default=0, type=int, help="interaction row within the file")
    p.add_argument("--num-gt", default=None, type=int, help="GT count for recall")
    p.add_argument("--output", default="pr_curve.png")
    args = p.parse_args(argv)

    path, scores = ranked_scores(args.cache_dir, args.object, args.row)
    print(f"{path} row {args.row}: {len(scores)} detections")
    if len(scores) == 0:
        return
    plot_scores(scores, args.num_gt, args.output)


if __name__ == "__main__":
    main()
