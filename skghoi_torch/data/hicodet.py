"""HICO-DET dataset over the reference's JSON annotation schema.

Schema (reference ``hicodet/hicodet.py:270-293``): ``instances_*.json`` holds
``filenames``, ``size`` (w, h per image), ``empty`` (indices without
annotations, skipped), ``annotation`` (per image: ``boxes_h``, ``boxes_o``,
``hoi``, ``verb``, ``object`` lists), ``correspondence`` (600 x [hoi, object,
verb]), ``objects``/``verbs`` name lists.

Mirrors ``skghoi_tpu.data.hicodet``.  Class-correspondence lookups mirror
the reference properties (``hicodet/hicodet.py:121-246``); images are decoded
lazily with PIL into ``[H, W, 3]`` uint8 arrays, the only use of an image
library in the port.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from skghoi_torch import constants as C


class HICODet:
    num_object_cls = C.HICO_NUM_OBJECTS
    num_interaction_cls = C.HICO_NUM_INTERACTIONS
    num_action_cls = C.HICO_NUM_VERBS

    def __init__(self, root: str, anno_file: str):
        self._root = root
        self._anno_file = anno_file
        with open(anno_file, "r") as f:
            f_dict = json.load(f)
        self._load_annotation_and_metadata(f_dict)

    def _load_annotation_and_metadata(self, f: dict) -> None:
        idx = list(range(len(f["filenames"])))
        for empty_idx in sorted(f.get("empty", []), reverse=True):
            idx.remove(empty_idx)

        num_anno = [0] * self.num_interaction_cls
        for anno in f["annotation"]:
            for hoi in anno["hoi"]:
                num_anno[hoi] += 1

        self._idx = idx
        self._num_anno = num_anno
        self._anno = f["annotation"]
        self._filenames = f["filenames"]
        self._image_sizes = f["size"]
        self._class_corr = f["correspondence"]
        self._empty_idx = f.get("empty", [])
        self._objects = f.get("objects", [])
        self._verbs = f.get("verbs", [])

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._idx)

    def __getitem__(self, i: int):
        intra_idx = self._idx[i]
        return self.load_image(
            os.path.join(self._root, self._filenames[intra_idx])
        ), dict(self._anno[intra_idx])

    def load_image(self, path: str) -> np.ndarray:
        """Decode a JPEG into an ``[H, W, 3]`` uint8 RGB array."""
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def filename(self, idx: int) -> str:
        return self._filenames[self._idx[idx]]

    def image_size(self, idx: int) -> Tuple[int, int]:
        """(width, height)"""
        return tuple(self._image_sizes[self._idx[idx]])

    def raw_target(self, idx: int) -> dict:
        """Annotation dict for dataset index ``idx`` (no image decode)."""
        return dict(self._anno[self._idx[idx]])

    # ------------------------------------------------------------------
    @property
    def annotations(self) -> List[dict]:
        return self._anno

    @property
    def class_corr(self) -> List[List[int]]:
        """[[hoi_idx, object_idx, verb_idx], ...] zero-based."""
        return [list(c) for c in self._class_corr]

    @property
    def object_n_verb_to_interaction(self) -> List[list]:
        lut = np.full((self.num_object_cls, self.num_action_cls), None)
        for i, j, k in self._class_corr:
            lut[j, k] = i
        return lut.tolist()

    @property
    def object_to_interaction(self) -> List[list]:
        out = [[] for _ in range(self.num_object_cls)]
        for hoi, obj, _ in self._class_corr:
            out[obj].append(hoi)
        return out

    @property
    def object_to_verb(self) -> List[list]:
        out = [[] for _ in range(self.num_object_cls)]
        for _, obj, verb in self._class_corr:
            out[obj].append(verb)
        return out

    @property
    def anno_interaction(self) -> List[int]:
        return list(self._num_anno)

    @property
    def anno_object(self) -> List[int]:
        out = [0] * self.num_object_cls
        for hoi, obj, _ in self._class_corr:
            out[obj] += self._num_anno[hoi]
        return out

    @property
    def anno_action(self) -> List[int]:
        out = [0] * self.num_action_cls
        for hoi, _, verb in self._class_corr:
            out[verb] += self._num_anno[hoi]
        return out

    @property
    def objects(self) -> List[str]:
        return list(self._objects)

    @property
    def verbs(self) -> List[str]:
        return list(self._verbs)

    @property
    def interactions(self) -> List[str]:
        return [
            self._verbs[v] + " " + self._objects[o] for _, o, v in self._class_corr
        ]

    def split(self, ratio: float, seed: Optional[int] = None):
        """Random (train, val) subset split (reference ``:248-260``)."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self._idx))
        n = int(len(perm) * ratio)
        return HICODetSubset(self, perm[:n].tolist()), HICODetSubset(self, perm[n:].tolist())

    def object_verb_mask(self) -> np.ndarray:
        """[num_object, num_verb] float32 validity mask for prior scores."""
        mask = np.zeros((self.num_object_cls, self.num_action_cls), np.float32)
        for _, obj, verb in self._class_corr:
            mask[obj, verb] = 1.0
        return mask


class HICODetSubset:
    """Index-subset view exposing the same surface (reference ``:17-50``)."""

    def __init__(self, dataset: HICODet, pool: List[int]):
        self.dataset = dataset
        self.pool = pool

    def __len__(self) -> int:
        return len(self.pool)

    def __getitem__(self, i: int):
        return self.dataset[self.pool[i]]

    def filename(self, idx: int) -> str:
        return self.dataset.filename(self.pool[idx])

    def image_size(self, idx: int) -> Tuple[int, int]:
        return self.dataset.image_size(self.pool[idx])

    def raw_target(self, idx: int) -> dict:
        return self.dataset.raw_target(self.pool[idx])

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    @property
    def anno_interaction(self) -> List[int]:
        num = [0] * self.dataset.num_interaction_cls
        for i in self.pool:
            intra = self.dataset._idx[i]
            for hoi in self.dataset._anno[intra]["hoi"]:
                num[hoi] += 1
        return num
