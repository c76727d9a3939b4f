"""Canonical KGE training configurations (OpenKE examples parity).

The reference ships one script per (model, benchmark) combination under
``OpenKE/examples/`` plus ``train_transe_FB15K237.py``; the hyper-parameters
below reproduce those canonical setups as data.  A copy of
``skghoi_tpu.kge.examples``.  Use via::

    python -m skghoi_torch.tools.train_kge --example transe_fb15k237 --data <dir>

(the example only presets flags; any explicit flag still overrides).  The
HOI-flavoured TransH config mirrors ``OpenKE/examples/configues/hoi_linearH.py``
(dim 200, margin 4.0) used to pretrain embeddings for the interaction head.
"""

EXAMPLES = {
    # train_transe_FB15K237.py:9-46
    "transe_fb15k237": dict(
        model="transe", dim=200, p_norm=1, margin=5.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=1.0, opt="sgd",
    ),
    # train_transe_WN18_adv_sigmoidloss.py (despite the filename it reads
    # benchmarks/WN18RR — the recipe behind the published WN18RR 0.512):
    # dim 1024, norm_flag False, margin 6, sigmoid adv T=1, batch 2000
    # (86835 triples -> 43 nbatches), neg 64, adam 2e-5, 3000 epochs.
    "transe_wn18rr": dict(
        sampling_mode="oneside",
        model="transe", dim=1024, p_norm=1, no_norm=True, margin=6.0,
        loss="sigmoid", adv_temperature=1.0, nbatches=43, neg_ent=64,
        bern=False, epochs=3000, alpha=2e-5, opt="adam",
    ),
    "transh_fb15k237": dict(
        model="transh", dim=200, p_norm=1, margin=4.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="sgd",
    ),
    # No shipped TransH/R/D WN18RR scripts exist; the published README rows
    # (0.507/0.519/0.508) sit next to TransE's 0.512, so these adapt the
    # shipped TransE WN18RR adv recipe to each model.  TransR keeps
    # norm_flag True (its transfer matrices blow up un-normalized) and the
    # margin-loss pretrain recipe at WN18RR's 11 relations.
    "transh_wn18rr": dict(
        sampling_mode="oneside",
        model="transh", dim=1024, p_norm=1, no_norm=True, margin=6.0,
        loss="sigmoid", adv_temperature=1.0, nbatches=43, neg_ent=64,
        bern=False, epochs=3000, alpha=2e-5, opt="adam",
    ),
    "transr_wn18rr": dict(
        model="transr", dim=200, p_norm=1, margin=4.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=1.0, opt="sgd",
        sampling_mode="oneside", transe_init_epochs=1,
    ),
    "transd_wn18rr": dict(
        sampling_mode="oneside",
        model="transd", dim=1024, p_norm=1, no_norm=True, margin=6.0,
        loss="sigmoid", adv_temperature=1.0, nbatches=43, neg_ent=64,
        bern=False, epochs=3000, alpha=2e-5, opt="adam",
    ),
    # hoi_linearH.py: TransH for the HOI knowledge graph (dim 200, margin 4)
    "transh_hoi": dict(
        model="transh", dim=200, p_norm=2, margin=4.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=500, alpha=0.5, opt="sgd",
    ),
    # train_transr_FB15K237.py:24-60 — published 0.511 requires the 1-epoch
    # TransE warm start.  sampling_mode oneside: the specialized
    # score_one_side gathers ONE transfer matrix per row, so dim-200
    # training fits device memory without the chunked score path.
    "transr_fb15k237": dict(
        model="transr", dim=200, p_norm=1, margin=4.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=1.0, opt="sgd",
        sampling_mode="oneside", transe_init_epochs=1,
    ),
    "transd_fb15k237": dict(
        model="transd", dim=200, p_norm=1, margin=4.0, loss="margin",
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=1.0, opt="sgd",
    ),
    # NOTE (applies to all bilinear FB15K237 presets below):
    # OpenKE's WN18RR example uses regul_rate 1.0, which on FB15K237
    # collapses DistMult (Hits@10 0.068); 0.05 reproduces the published 0.419
    # (the JAX package measured 0.411 with this preset).
    "distmult_fb15k237": dict(
        model="distmult", dim=200, loss="softplus", regul_rate=0.05,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    "complex_fb15k237": dict(
        model="complex", dim=200, loss="softplus", regul_rate=0.05,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    "analogy_fb15k237": dict(
        model="analogy", dim=200, loss="softplus", regul_rate=0.05,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    "simple_fb15k237": dict(
        model="simple", dim=200, loss="softplus", regul_rate=0.05,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    "rescal_fb15k237": dict(
        model="rescal", dim=50, loss="margin", margin=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.1, opt="adagrad",
    ),
    # No shipped FB15K237 RotatE script; the published RotatE(+adv) 0.522 row
    # (README.md:98) is approached with the WN18RR adv script's shape carried
    # over: batch 2000 (272115 triples -> 136 nbatches), neg 64, sigmoid adv
    # T=1, adam 2e-5 (1000 epochs = 136k steps, the RotatE paper's step scale).
    "rotate_fb15k237": dict(
        sampling_mode="oneside",
        model="rotate", dim=1024, margin=6.0, loss="sigmoid", adv_temperature=1.0,
        nbatches=136, neg_ent=64, bern=False, epochs=1000, alpha=2e-5, opt="adam",
    ),
    "hole_fb15k237": dict(
        model="hole", dim=100, loss="softplus", regul_rate=0.05,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    # --- WN18RR example scripts (examples/train_*_WN18RR.py) ---
    # distmult/complex/analogy/simple: dim 200, softplus, regul 1.0, adagrad
    # 0.5, 2000 epochs (regul 1.0 is correct on WN18RR; see FB15K237 note).
    "distmult_wn18rr": dict(
        model="distmult", dim=200, loss="softplus", regul_rate=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=2000, alpha=0.5, opt="adagrad",
    ),
    "complex_wn18rr": dict(
        model="complex", dim=200, loss="softplus", regul_rate=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=2000, alpha=0.5, opt="adagrad",
    ),
    "analogy_wn18rr": dict(
        model="analogy", dim=200, loss="softplus", regul_rate=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=2000, alpha=0.5, opt="adagrad",
    ),
    "simple_wn18rr": dict(
        model="simple", dim=200, loss="softplus", regul_rate=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=2000, alpha=0.5, opt="adagrad",
    ),
    "hole_wn18rr": dict(
        model="hole", dim=100, loss="softplus", regul_rate=1.0,
        nbatches=100, neg_ent=25, bern=True, epochs=1000, alpha=0.5, opt="adagrad",
    ),
    # train_rotate_WN18RR_adv.py: batch 2000 (~43 nbatches of 86835 triples),
    # neg 64, sigmoid adv T=2, adam 2e-5, 6000 epochs — published 0.565.
    "rotate_wn18rr_adv": dict(
        sampling_mode="oneside",
        model="rotate", dim=1024, margin=6.0, loss="sigmoid", adv_temperature=2.0,
        nbatches=43, neg_ent=64, bern=False, epochs=6000, alpha=2e-5, opt="adam",
    ),
    # train_distmult_WN18RR_adv.py: dim 1024, sigmoid adv T=0.5, l3 5e-6,
    # adam 0.002, 400 epochs, batch 2000, neg 64; margin=200/epsilon=2 only
    # set the uniform init range (DistMult.py:16-32).
    "distmult_wn18rr_adv": dict(
        sampling_mode="oneside",
        model="distmult", dim=1024, loss="sigmoid", adv_temperature=0.5,
        init_margin=200.0, init_epsilon=2.0,
        l3_regul_rate=5e-6, nbatches=43, neg_ent=64, bern=False, epochs=400,
        alpha=0.002, opt="adam",
    ),
}
