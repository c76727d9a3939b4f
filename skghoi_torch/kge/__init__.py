"""Knowledge-graph-embedding toolkit with OpenKE capability parity, on a CUDA card.

Mirrors ``skghoi_tpu.kge``: the eleven OpenKE models
(TransE/TransH/TransR/TransD/DistMult/ComplEx/RESCAL/Analogy/SimplE/RotatE/
HolE), margin/sigmoid/softplus losses, the negative-sampling strategy with
filtered Bernoulli corruption drawn on the device, a trainer whose epoch
reads nothing back until its log line, and a tester that ranks every entity
on the device (raw, filtered, type-constrained) plus triple classification.
"""

from skghoi_torch.kge.data import KGData
from skghoi_torch.kge.losses import MarginLoss, SigmoidLoss, SoftplusLoss
from skghoi_torch.kge.models import (
    Analogy,
    ComplEx,
    DistMult,
    HolE,
    RESCAL,
    RotatE,
    SimplE,
    TransD,
    TransE,
    TransH,
    TransR,
)
from skghoi_torch.kge.strategy import NegativeSampling
from skghoi_torch.kge.tester import Tester
from skghoi_torch.kge.trainer import Trainer

__all__ = [
    "KGData",
    "MarginLoss",
    "SigmoidLoss",
    "SoftplusLoss",
    "TransE",
    "TransH",
    "TransR",
    "TransD",
    "DistMult",
    "ComplEx",
    "RESCAL",
    "Analogy",
    "SimplE",
    "RotatE",
    "HolE",
    "NegativeSampling",
    "Trainer",
    "Tester",
]
