"""Train + evaluate a KGE model on an OpenKE-format benchmark, on a CUDA card.

Mirrors ``skghoi_tpu.tools.train_kge`` (the reference
``OpenKE/train_transe_FB15K237.py``):

    TrainDataLoader(nbatches=100, threads=8, bern, filter, neg_ent=25)
    TransE(dim=200, p_norm=1, norm_flag=True)
    NegativeSampling + MarginLoss(5.0)
    Trainer(train_times=1000, alpha=1.0, SGD) ; Tester.run_link_prediction

Example::

    python -m skghoi_torch.tools.train_kge --data benchmarks/FB15K237 \\
        --example transe_fb15k237

The same flags as the JAX tool, except that ``--device`` (default ``cuda``;
``cpu`` on request) replaces ``--cpu``.  ``--data-parallel`` trains over the
processes that torchrun started, one per card (each samples its share of the
batch; gradients and loss are averaged, see :class:`~skghoi_torch.kge.trainer.Trainer`)::

    python -m torch.distributed.run --nproc-per-node 4 -m skghoi_torch.tools.train_kge \
        --data benchmarks/FB15K237 --example transe_fb15k237 --data-parallel

Only rank 0 evaluates, prints the result and writes files; run plainly,
``--data-parallel`` is a group of one.  Checkpoints are ``torch.save`` state
dicts with OpenKE's table names.

Published parity target: TransE FB15K237 Hits@10(filter) ~ 0.476
(reference ``OpenKE/README.md:90``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from skghoi_torch.kge import (
    Analogy,
    ComplEx,
    DistMult,
    HolE,
    KGData,
    MarginLoss,
    NegativeSampling,
    RESCAL,
    RotatE,
    SigmoidLoss,
    SimplE,
    SoftplusLoss,
    Tester,
    Trainer,
    TransD,
    TransE,
    TransH,
    TransR,
)
from skghoi_torch.kge.sampling import DeviceKG
from skghoi_torch.parallel import distributed


def _trans_margin(a):
    """OpenKE margin_flag semantics: with a rank-based loss the model's
    forward is the raw distance (the margin lives in MarginLoss); with
    sigmoid/softplus losses the adversarial examples construct
    ``TransX(margin=m)`` so forward becomes ``margin - distance`` — the
    higher-is-better score those losses require
    (``examples/train_transe_WN18_adv_sigmoidloss.py:29``, ``Model.forward``)."""
    return a.margin if a.loss in ("sigmoid", "softplus") else None


MODELS = {
    "transe": lambda a, d: TransE(d.ent_tot, d.rel_tot, dim=a.dim, p_norm=a.p_norm, norm_flag=not a.no_norm, margin=_trans_margin(a)),
    "transh": lambda a, d: TransH(d.ent_tot, d.rel_tot, dim=a.dim, p_norm=a.p_norm, norm_flag=not a.no_norm, margin=_trans_margin(a)),
    "transr": lambda a, d: TransR(d.ent_tot, d.rel_tot, dim_e=a.dim, dim_r=a.dim, p_norm=a.p_norm, norm_flag=not a.no_norm, score_chunk=a.score_chunk, margin=_trans_margin(a)),
    "transd": lambda a, d: TransD(d.ent_tot, d.rel_tot, dim_e=a.dim, dim_r=a.dim, p_norm=a.p_norm, norm_flag=not a.no_norm, margin=_trans_margin(a)),
    "distmult": lambda a, d: DistMult(d.ent_tot, d.rel_tot, dim=a.dim, margin=a.init_margin, epsilon=a.init_epsilon),
    "complex": lambda a, d: ComplEx(d.ent_tot, d.rel_tot, dim=a.dim),
    "rescal": lambda a, d: RESCAL(d.ent_tot, d.rel_tot, dim=a.dim),
    "analogy": lambda a, d: Analogy(d.ent_tot, d.rel_tot, dim=a.dim),
    "simple": lambda a, d: SimplE(d.ent_tot, d.rel_tot, dim=a.dim),
    "rotate": lambda a, d: RotatE(d.ent_tot, d.rel_tot, dim=a.dim, margin=a.margin),
    "hole": lambda a, d: HolE(d.ent_tot, d.rel_tot, dim=a.dim),
}

LOSSES = {
    "margin": lambda a: MarginLoss(margin=a.margin, adv_temperature=a.adv_temperature),
    "sigmoid": lambda a: SigmoidLoss(adv_temperature=a.adv_temperature),
    "softplus": lambda a: SoftplusLoss(adv_temperature=a.adv_temperature),
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="OpenKE-parity KGE training on a CUDA card")
    p.add_argument("--data", required=True, help="benchmark dir with *2id.txt files")
    p.add_argument("--example", default=None, help="preset config name (see kge/examples.py)")
    p.add_argument("--model", default="transe", choices=sorted(MODELS))
    p.add_argument("--loss", default="margin", choices=sorted(LOSSES))
    p.add_argument("--dim", type=int, default=200)
    p.add_argument("--p-norm", type=int, default=1)
    p.add_argument("--no-norm", action="store_true", help="disable score-time L2 normalization")
    p.add_argument("--margin", type=float, default=5.0)
    p.add_argument("--adv-temperature", type=float, default=None)
    p.add_argument("--nbatches", type=int, default=100)
    p.add_argument("--neg-ent", type=int, default=25)
    p.add_argument("--bern", action="store_true")
    p.add_argument("--no-filter", action="store_true")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--alpha", type=float, default=1.0, help="learning rate")
    p.add_argument("--opt", default="sgd", choices=["sgd", "adam", "adagrad", "adadelta"])
    p.add_argument("--regul-rate", type=float, default=0.0)
    p.add_argument("--l3-regul-rate", type=float, default=0.0)
    p.add_argument("--data-parallel", action="store_true",
                   help="train over the ranks that torchrun started, one per card "
                        "(batch split across them, gradients averaged)")
    p.add_argument("--sampling-mode", default="normal", choices=["normal", "oneside"],
                   help="'oneside': per-row corruption side + folded scoring "
                        "(the reference's cross-mode structure)")
    p.add_argument("--init-margin", type=float, default=None,
                   help="DistMult: uniform init range (margin+epsilon)/dim instead of Xavier")
    p.add_argument("--init-epsilon", type=float, default=None)
    p.add_argument("--score-chunk", type=int, default=None,
                   help="TransR: chunked+rematerialized scoring (memory bound)")
    p.add_argument("--transe-init-epochs", type=int, default=0,
                   help="TransR published recipe: pretrain TransE this many "
                        "epochs (margin 5.0, alpha 0.5, SGD) and copy its "
                        "entity/relation tables in (train_transr_FB15K237.py)")
    p.add_argument("--json-out", default=None,
                   help="append the JSON result line to this file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, help="save final params here")
    p.add_argument("--load-checkpoint", default=None,
                   help="restore params from a prior --checkpoint file before "
                        "(optionally zero) further training; with --epochs 0 "
                        "this is an eval-only run of a saved checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; 'cpu' runs the plain path there)")
    p.add_argument("--eval-chunk", type=int, default=16)
    p.add_argument("--type-constrain", action="store_true")
    p.add_argument("--skip-eval", action="store_true")
    p.add_argument("--json", action="store_true", help="print one JSON result line")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """Parsed flags with the ``--example`` preset applied under any explicit flag."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.example:
        from skghoi_torch.kge.examples import EXAMPLES

        preset = EXAMPLES[args.example]
        explicit = {a.dest for a in parser._actions
                    if parser.get_default(a.dest) != getattr(args, a.dest, None)}
        for k, v in preset.items():
            if k not in explicit:
                setattr(args, k, v)
        print(f"Using example config '{args.example}': {preset}")
    return args


def build_model(args, data: KGData, device: torch.device):
    """``args.model`` with tables drawn from ``args.seed`` (on the CPU, so a
    seed gives the same start on every device), moved to ``device``."""
    model = MODELS[args.model](args, data)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    return model.to(device)


def build_trainer(args, model, kg: DeviceKG, epochs: int, batches=None) -> Trainer:
    """The trainer of ``args`` (``batches``: see :class:`~skghoi_torch.kge.trainer.Trainer`);
    data parallel when ``--data-parallel`` started a process group."""
    strategy = NegativeSampling(loss=LOSSES[args.loss](args), regul_rate=args.regul_rate,
                                l3_regul_rate=args.l3_regul_rate)
    return Trainer(model, strategy, kg, nbatches=args.nbatches, neg_rate=args.neg_ent,
                   bern=args.bern, filtered=not args.no_filter, train_times=epochs,
                   alpha=args.alpha, opt_method=args.opt, seed=args.seed,
                   sampling_mode=args.sampling_mode, batches=batches)


def _save(model, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(model.state_dict(), path)
    print(f"Saved {path}")


def main(argv=None):
    """Returns the :class:`~skghoi_torch.kge.tester.LinkPredictionResult`
    (``None`` with ``--skip-eval``, and on ranks other than 0)."""
    from skghoi_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device if args.device is not None
                            else distributed.device_for(cpu=False))
    own_group = args.data_parallel and distributed.initialize(device)
    try:
        if distributed.is_main():
            return _run(args, device)
        with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
            return _run(args, device)  # the log lines are rank 0's
    finally:
        if own_group:
            distributed.shutdown()


def _run(args, device):
    data = KGData.load(args.data, with_type_constrain=args.type_constrain)
    kg = DeviceKG.from_kgdata(data, device)
    print(f"Loaded {args.data}: {data.ent_tot} entities, {data.rel_tot} relations, "
          f"{data.train_total} train / {len(data.valid)} valid / {len(data.test)} test triples")

    model = build_model(args, data, device)
    if args.load_checkpoint:
        model.load_state_dict(torch.load(args.load_checkpoint, map_location=device,
                                         weights_only=True))
        print(f"Loaded checkpoint {args.load_checkpoint}")

    if args.transe_init_epochs > 0:
        # Published TransR recipe (train_transr_FB15K237.py:24-56): TransE(dim,
        # p1, norm) with MarginLoss(5.0)/SGD(0.5), then copy the entity and
        # relation tables into the model (transfer matrices stay as they are).
        print(f"Pretraining TransE for {args.transe_init_epochs} epoch(s) to seed {args.model}")
        pre = argparse.Namespace(**{**vars(args), "model": "transe", "no_norm": False,
                                    "loss": "margin", "margin": 5.0, "adv_temperature": None,
                                    "alpha": 0.5, "opt": "sgd", "sampling_mode": "normal",
                                    "regul_rate": 0.0, "l3_regul_rate": 0.0})
        pre_model = build_model(pre, data, device)
        build_trainer(pre, pre_model, kg, args.transe_init_epochs).run()
        with torch.no_grad():
            model.ent_embeddings.weight.copy_(pre_model.ent_embeddings.weight)
            model.rel_embeddings.weight.copy_(pre_model.rel_embeddings.weight)

    if args.epochs > 0:
        trainer = build_trainer(args, model, kg, args.epochs)
        t0 = time.time()
        trainer.run()  # ends on the last epoch's loss read
        train_time = time.time() - t0
        steps = args.epochs * args.nbatches
        print(f"Training: {train_time:.1f}s for {steps} steps ({steps / max(train_time, 1e-9):.1f} "
              f"steps/s)" + (f" on {distributed.world_size()} ranks" if args.data_parallel else ""))
    else:
        train_time, steps = 0.0, 0
        print("Training skipped (--epochs 0): evaluating loaded/initial params")
    if not distributed.is_main():
        return None
    if args.checkpoint:
        _save(model, args.checkpoint)

    if args.skip_eval:
        return None
    tester = Tester(model, data, chunk_size=args.eval_chunk)
    t0 = time.time()
    res = tester.run_link_prediction(type_constrain=args.type_constrain)
    eval_time = time.time() - t0
    print(f"Evaluation: {eval_time:.1f}s for {2 * len(data.test)} ranking queries")
    if args.json or args.json_out:
        line = json.dumps({
            "model": args.model, "data": args.data,
            "example": args.example, "seed": args.seed,
            "platform": device.type,
            "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "cli": vars(args),
            "mrr": res.mrr, "mr": res.mr,
            "hit10": res.hit10, "hit3": res.hit3, "hit1": res.hit1,
            "train_seconds": train_time, "steps_per_second": steps / max(train_time, 1e-9),
            "eval_seconds": eval_time,
        })
        if args.json:
            print(line)
        if args.json_out:
            with open(args.json_out, "a") as f:
                f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
