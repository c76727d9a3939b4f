"""Link-prediction and triple-classification evaluation, ranked on the device.

Mirrors ``skghoi_tpu.kge.tester`` (the reference
``OpenKE/openke/config/Tester.py:70-91`` + ``Test.h``): for each test
triple, score **all entities** substituted as head and as tail, then count
entities scoring strictly better than the ground truth: raw, filtered
(excluding any known train/valid/test triple), and type-constrained.  Rank
semantics: lower ``rank_scores`` = better; ``rank = 1 + #{j != gt : s_j <
s_gt}``; hits@k = rank <= k; the metrics average the head and tail sides
over the test set (``Test.h:230-277``).

Test triples go through in chunks of ``chunk_size``; each chunk scores a
``[C, E]`` grid per side (``rank_all_*`` for models that have them, else
``rank_scores`` over broadcast id grids), filters it through the exact
known-triple set, and keeps its ranks on the device.  The ranks of all
chunks come to the host in one read at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from skghoi_torch.kge.data import KGData
from skghoi_torch.kge.sampling import NumpySampler, TripleSet

RANK_KEYS = ("head_raw", "head_filt", "tail_raw", "tail_filt", "head_cons", "tail_cons")


@dataclass
class LinkPredictionResult:
    mrr: float
    mr: float
    hit10: float
    hit3: float
    hit1: float
    raw: Dict[str, float]

    def __iter__(self):  # keeps the reference's tuple-return usable
        return iter((self.mrr, self.mr, self.hit10, self.hit3, self.hit1))


class Tester:
    def __init__(self, model, data: KGData, chunk_size: int = 16):
        self.model = model
        self.data = data
        self.chunk_size = chunk_size
        self.device = next(model.parameters()).device
        allt = np.concatenate([data.train, data.valid, data.test], axis=0)
        self._known = TripleSet(allt[:, 0], allt[:, 2], allt[:, 1], data.rel_tot, data.ent_tot,
                                self.device)

    def _type_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[R, E]`` admissible-head and admissible-tail masks, on the device."""
        masks = np.zeros((2, self.data.rel_tot, self.data.ent_tot), bool)
        if self.data.head_type is not None:
            for store, m in zip((self.data.head_type, self.data.tail_type), masks):
                for r, ents in store.items():
                    m[r, ents] = True
        masks = torch.from_numpy(masks).to(self.device)
        return masks[0], masks[1]

    @torch.no_grad()
    def _chunk_ranks(self, h, t, r, type_tables):
        """h/t/r: ``[C]`` on the device -> ``[6, C]`` ranks (:data:`RANK_KEYS`;
        the constrained rows are 0 without ``type_tables``)."""
        model, n_ent = self.model, self.data.ent_tot
        ents = torch.arange(n_ent, device=self.device)[None, :].expand(len(h), n_ent)
        if hasattr(type(model), "rank_all_tails"):
            head_scores, tail_scores = model.rank_all_heads(t, r), model.rank_all_tails(h, r)
        else:
            rb = r[:, None].expand_as(ents)
            head_scores = model.rank_scores(ents, t[:, None].expand_as(ents), rb)
            tail_scores = model.rank_scores(h[:, None].expand_as(ents), ents, rb)

        def side(scores, gt, known, cand):
            better = (scores < scores.gather(1, gt[:, None])) & (ents != gt[:, None])
            filt = better & ~known
            cons = (filt & cand).sum(1) + 1 if cand is not None else torch.zeros_like(gt)
            return 1 + better.sum(1), 1 + filt.sum(1), cons

        rb = r[:, None].expand_as(ents)
        head_cand = tail_cand = None
        if type_tables is not None:
            head_cand, tail_cand = type_tables[0][r], type_tables[1][r]
        hr, hf, hc = side(head_scores, h, self._known.contains(ents, rb, t[:, None]), head_cand)
        tr, tf, tc = side(tail_scores, t, self._known.contains(h[:, None], rb, ents), tail_cand)
        return torch.stack([hr, hf, tr, tf, hc, tc])

    def ranks(self, type_constrain: bool = False) -> Dict[str, np.ndarray]:
        """Per-test-triple ranks (:data:`RANK_KEYS`), read from the device once."""
        if not len(self.data.test):
            raise ValueError("No test triples loaded")
        test = torch.from_numpy(self.data.test).to(self.device)
        tables = self._type_tables() if type_constrain else None
        chunks = [self._chunk_ranks(c[:, 0], c[:, 1], c[:, 2], tables)
                  for c in torch.split(test, self.chunk_size)]
        return dict(zip(RANK_KEYS, torch.cat(chunks, dim=1).cpu().numpy()))

    def run_link_prediction(self, type_constrain: bool = False, log_fn=print) -> LinkPredictionResult:
        ranks = self.ranks(type_constrain)

        def agg(key):
            x = ranks[key].astype(np.float64)
            return dict(mrr=float(np.mean(1.0 / x)), mr=float(np.mean(x)),
                        hit10=float(np.mean(x <= 10)), hit3=float(np.mean(x <= 3)),
                        hit1=float(np.mean(x <= 1)))

        def avg(a, b):
            return {k: (a[k] + b[k]) / 2 for k in a}

        l_raw, r_raw = agg("head_raw"), agg("tail_raw")
        l_f, r_f = agg("head_filt"), agg("tail_filt")
        raw_avg, filt_avg = avg(l_raw, r_raw), avg(l_f, r_f)

        log_fn("no type constraint results:")
        log_fn("metric:\t\t\t MRR \t\t MR \t\t hit@10 \t hit@3  \t hit@1")
        for name, m in (("l(raw)", l_raw), ("r(raw)", r_raw), ("averaged(raw)", raw_avg)):
            log_fn(
                f"{name}:\t\t {m['mrr']:f} \t {m['mr']:f} \t {m['hit10']:f} \t {m['hit3']:f} \t {m['hit1']:f}"
            )
        for name, m in (("l(filter)", l_f), ("r(filter)", r_f), ("averaged(filter)", filt_avg)):
            log_fn(
                f"{name}:\t {m['mrr']:f} \t {m['mr']:f} \t {m['hit10']:f} \t {m['hit3']:f} \t {m['hit1']:f}"
            )
        if type_constrain:
            cons_avg = avg(agg("head_cons"), agg("tail_cons"))
            log_fn(
                f"type-constrained(filter): MRR {cons_avg['mrr']:f} MR {cons_avg['mr']:f} "
                f"hit@10 {cons_avg['hit10']:f} hit@3 {cons_avg['hit3']:f} hit@1 {cons_avg['hit1']:f}"
            )
            filt_avg = cons_avg

        return LinkPredictionResult(mrr=filt_avg["mrr"], mr=filt_avg["mr"], hit10=filt_avg["hit10"],
                                    hit3=filt_avg["hit3"], hit1=filt_avg["hit1"], raw=raw_avg)

    # ------------------------------------------------------------------
    # Triple classification (Tester.py:93-151)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _score_triples(self, triples: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(np.ascontiguousarray(triples, np.int64)).to(self.device)
        c = max(self.chunk_size * 64, 256)
        out = [self.model.rank_scores(x[:, 0], x[:, 1], x[:, 2]) for x in torch.split(ids, c)]
        return torch.cat(out).cpu().numpy()

    @staticmethod
    def _corrupt_for_classification(data: KGData, triples: np.ndarray, seed: int) -> np.ndarray:
        """One filtered corruption per triple (50/50 head/tail), as getNegTest."""
        sampler = NumpySampler(data, seed=seed)
        rng = np.random.default_rng(seed + 1)
        out = triples.copy()
        for i, (h, t, r) in enumerate(triples):
            if rng.random() < 0.5:
                out[i, 1] = sampler._corrupt(
                    sampler._ht_keys, sampler._ht_tails, h * data.rel_tot + r, 1
                )[0]
            else:
                out[i, 0] = sampler._corrupt(
                    sampler._th_keys, sampler._th_heads, t * data.rel_tot + r, 1
                )[0]
        return out

    @staticmethod
    def get_best_threshold(score: np.ndarray, ans: np.ndarray) -> Tuple[float, float]:
        """Accuracy-maximizing threshold sweep (Tester.py:93-113 semantics)."""
        order = np.argsort(score, kind="stable")
        s, a = score[order], ans[order]
        total = float(len(score))
        total_false = total - a.sum()
        tp = np.cumsum(a)  # positives with score <= s[i]
        acc = (2 * tp + total_false - np.arange(1, len(s) + 1)) / total
        best = int(np.argmax(acc))
        return float(s[best]), float(acc[best])

    def run_triple_classification(self, threshold: Optional[float] = None,
                                  seed: int = 0) -> Tuple[float, float]:
        data = self.data
        neg_test = self._corrupt_for_classification(data, data.test, seed)
        pos_scores = self._score_triples(data.test)
        neg_scores = self._score_triples(neg_test)

        if threshold is None:
            if len(data.valid):
                neg_valid = self._corrupt_for_classification(data, data.valid, seed + 7)
                v_scores = np.concatenate(
                    [self._score_triples(data.valid), self._score_triples(neg_valid)]
                )
                v_ans = np.concatenate([np.ones(len(data.valid)), np.zeros(len(neg_valid))])
            else:
                v_scores = np.concatenate([pos_scores, neg_scores])
                v_ans = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
            threshold, _ = self.get_best_threshold(v_scores, v_ans)

        scores = np.concatenate([pos_scores, neg_scores])
        ans = np.concatenate([np.ones(len(pos_scores)), np.zeros(len(neg_scores))])
        pred = scores <= threshold  # lower rank-score = plausible
        acc = float(np.mean(pred == ans.astype(bool)))
        return acc, float(threshold)
