"""Pretrain TransH on the HOI knowledge graph and export its embedding tables.

Mirrors ``skghoi_tpu.tools.pretrain_transh_hoi``: pretrain TransH on
(person, verb, object) triples (the reference's ``hoi_linearH`` OpenKE
config) so the interaction head starts from the embeddings:

1. build the HOI KG from HICO-DET annotations — one (human-class, verb,
   object-class) triple per annotated interaction class;
2. train TransH on it with the KGE trainer, on the card unless
   ``--device cpu``;
3. write the model's ``state_dict`` (``ent_embeddings.weight``,
   ``rel_embeddings.weight``, ``norm_vector.weight``: OpenKE's names) with
   ``torch.save``; ``train_hicodet --transh-init`` loads it into the SCG
   through :func:`load_pretrained_transh`.

    python -m skghoi_torch.tools.pretrain_transh_hoi --data-root hicodet --output transh_hoi.pt
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Mapping

import numpy as np
import torch

TRANSH_TABLES = ("ent_embeddings", "rel_embeddings", "norm_vector")


def build_hoi_triples(class_corr, human_idx: int) -> np.ndarray:
    """(h=human class, t=object class, r=verb) triples from the 600-class table."""
    triples = np.asarray([[human_idx, obj, verb] for _, obj, verb in class_corr], np.int64)
    return np.unique(triples, axis=0)


@torch.no_grad()
def load_pretrained_transh(model: torch.nn.Module, kge_state: Mapping) -> None:
    """Copy the TransH tables of ``kge_state`` (the ``state_dict`` this tool
    saves; a JAX KGE parameter tree goes through ``weights.kge_state_dict``
    first) into the SCG's ``interaction_head.box_pair_head.transh``; every
    shape must match."""
    transh = model.interaction_head.box_pair_head.transh
    for table in TRANSH_TABLES:
        dst, src = getattr(transh, table).weight, kge_state[f"{table}.weight"]
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"TransH table {table}: checkpoint {tuple(src.shape)}, "
                             f"SCG {tuple(dst.shape)}")
        dst.copy_(src)


def main(argv=None):
    """Returns the trained :class:`~skghoi_torch.kge.models.TransH`."""
    p = argparse.ArgumentParser(description="Pretrain TransH on the HOI KG")
    p.add_argument("--data-root", default="hicodet")
    p.add_argument("--partition", default="train2015")
    p.add_argument("--dim", default=50, type=int, help="must match the head (50)")
    p.add_argument("--margin", default=4.0, type=float, help="hoi_linearH margin")
    p.add_argument("--epochs", default=500, type=int)
    p.add_argument("--neg-ent", default=8, type=int)
    p.add_argument("--alpha", default=0.5, type=float)
    p.add_argument("--output", default="transh_hoi.pt")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda; 'cpu' runs the plain path there)")
    p.add_argument("--synthetic", action="store_true")
    args = p.parse_args(argv)

    from skghoi_torch import constants as C
    from skghoi_torch.data.hicodet import HICODet
    from skghoi_torch.device import resolve_device
    from skghoi_torch.kge import KGData, MarginLoss, NegativeSampling, Trainer, TransH
    from skghoi_torch.kge.sampling import DeviceKG

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="skghoi_kg_") as tmp:
        if args.synthetic:
            from skghoi_torch.data.synthetic import make_synthetic_hicodet

            make_synthetic_hicodet(tmp, args.partition, num_images=4)
            args.data_root = tmp
        dataset = HICODet(
            root=os.path.join(args.data_root, "hico_20160224_det/images", args.partition),
            anno_file=os.path.join(args.data_root, f"instances_{args.partition}.json"),
        )
        class_corr = dataset.class_corr
    triples = build_hoi_triples(class_corr, C.HICO_HUMAN_IDX)
    print(f"HOI KG: {len(triples)} triples, {C.HICO_NUM_OBJECTS} entities, "
          f"{C.HICO_NUM_VERBS} relations")

    data = KGData.build(C.HICO_NUM_OBJECTS, C.HICO_NUM_VERBS, triples)
    kg = DeviceKG.from_kgdata(data, device)
    model = TransH(C.HICO_NUM_OBJECTS, C.HICO_NUM_VERBS, dim=args.dim, p_norm=C.TRANSH_P_NORM,
                   norm_flag=C.TRANSH_NORM_FLAG)
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = Trainer(
        model.to(device), NegativeSampling(loss=MarginLoss(margin=args.margin)), kg,
        nbatches=4, neg_rate=args.neg_ent, bern=True, train_times=args.epochs,
        alpha=args.alpha, opt_method="sgd",
    )
    trainer.run()
    trainer.save_checkpoint(args.output)
    print(f"Saved TransH embeddings to {args.output}; load them with "
          f"train_hicodet --transh-init {args.output}.")
    return model


if __name__ == "__main__":
    main()
