"""Per-image diagnosis: dump box-pair scores and draw an overlay.

    python -m skghoi_torch.tools.demo --model-path ckpt_08.pt --index 0 [--cpu]

Mirrors ``skghoi_tpu.tools.demo`` (reference ``diagnosis/demo.py:49-129``):
run the network on one image from the dataset, print every detected
human-object pair with its top verb scores, and save a matplotlib overlay of
the pair boxes.  The forward is the float32 SCG eval forward that
``test_hicodet`` runs (seeded weights, then ``--model-path``'s, a port
checkpoint or a JAX variable tree), on ``cuda`` unless ``--cpu`` is given;
without a card it raises.  On the card the forward launches the RoIAlign
kernel once.  :func:`run` computes and prints; :func:`draw_overlay` draws
(the only place matplotlib is imported).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="SCG single-image demo")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--detection-dir", default="hicodet/detections/test2015")
    p.add_argument("--partition", default="test2015")
    p.add_argument("--index", default=0, type=int, help="dataset index to run")
    p.add_argument("--model-path", default="")
    p.add_argument("--top-k", default=5, type=int)
    p.add_argument("--output", default="demo_overlay.png")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    return p


def run(factory, index: int, model_path: str, device, top_k: int = 5) -> dict:
    """The forward on image ``index`` of ``factory``; prints each pair's
    top-``top_k`` verbs.  Returns the unpacked results (``res``), the
    outputs (``out``) and ``pairs``: ``(h, o) -> [(score, verb), ...]``,
    highest first."""
    from skghoi_torch.data.factory import collate
    from skghoi_torch.eval.hoi_eval import to_numpy, unpack_image_results
    from skghoi_torch.tools.test_hicodet import checkpoint_eval_step

    batch = collate([factory[index]], with_targets=False)
    eval_step = checkpoint_eval_step(device, factory.dataset.object_verb_mask(), model_path)
    out = to_numpy(eval_step(None, batch))
    res = unpack_image_results(out, batch, 0)

    # Group scores per pair, print top-k verbs each.
    verbs = factory.dataset.verbs
    pairs = {}
    for (x, y), k, s in zip(res["pair_index"], res["prediction"], res["scores"]):
        pairs.setdefault((int(x), int(y)), []).append((float(s), int(k)))
    print(f"Image {factory.dataset.filename(index)}: {len(pairs)} box pairs")
    for (x, y), entries in sorted(pairs.items()):
        entries.sort(reverse=True)
        tops = ", ".join(f"{verbs[k]}={s:.3f}" for s, k in entries[:top_k])
        print(f"  pair (h{x}, o{y}) object={factory.dataset.objects[int(out.object_class[0, y])]}: {tops}")
    return dict(res=res, out=out, pairs=pairs)


def draw_overlay(image, res: dict, pairs: dict, output: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(1)
    ax.imshow(image)
    for x, y in pairs:
        row = np.nonzero((res["pair_index"] == [x, y]).all(1))[0][0]
        bh, bo = res["boxes_h"][row], res["boxes_o"][row]
        ax.add_patch(Rectangle((bh[0], bh[1]), bh[2] - bh[0], bh[3] - bh[1], fill=False, color="lime"))
        ax.add_patch(Rectangle((bo[0], bo[1]), bo[2] - bo[0], bo[3] - bo[1], fill=False, color="red"))
    fig.savefig(output, dpi=120)
    plt.close(fig)
    print("Saved overlay to", output)


def main(argv=None):
    """Returns :func:`run`'s dict."""
    args = build_argparser().parse_args(argv)

    from skghoi_torch.data.factory import DataFactory
    from skghoi_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    factory_kwargs = {}
    if args.synthetic:
        import tempfile

        from skghoi_torch.data.synthetic import make_synthetic_hicodet

        root = tempfile.mkdtemp(prefix="skghoi_demo_")
        make_synthetic_hicodet(root, args.partition, num_images=4)
        args.data_root = root
        args.detection_dir = os.path.join(root, f"detections_{args.partition}")
        factory_kwargs = dict(
            min_size=64, max_size=107, canvas_landscape=(64, 96), canvas_portrait=(96, 64)
        )

    factory = DataFactory(
        "hicodet", args.partition, args.data_root, args.detection_dir, **factory_kwargs
    )
    result = run(factory, args.index, args.model_path, device, args.top_k)
    image, _ = factory.dataset[args.index]
    draw_overlay(image, result["res"], result["pairs"], args.output)
    return result


if __name__ == "__main__":
    main()
