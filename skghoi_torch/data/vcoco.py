"""V-COCO dataset over the reference's JSON annotation convention.

The reference consumes a ``VCOCO`` class from the (absent) ``vcoco`` submodule
via ``DataFactory`` (``utils.py:64-78,128-130``): images under
``mscoco2014/{train,val}2014`` with ``instances_vcoco_{partition}.json``;
targets expose ``boxes_h``, ``boxes_o``, ``actions`` (renamed ``labels``) and
``objects`` (renamed ``object``); ``human_idx`` is 1 and there are 24 action
classes.  This class reconstructs that surface with the same JSON schema
shape as :class:`~skghoi_torch.data.hicodet.HICODet` (filenames / size /
empty / annotation / correspondence-style ``object_to_action``).  Mirrors
``skghoi_tpu.data.vcoco``; images decode into ``[H, W, 3]`` uint8 arrays.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from skghoi_torch import constants as C


class VCOCO:
    num_object_cls = C.HICO_NUM_OBJECTS  # COCO 80-class vocabulary
    num_action_cls = C.VCOCO_NUM_ACTIONS

    def __init__(self, root: str, anno_file: str):
        self._root = root
        self._anno_file = anno_file
        with open(anno_file, "r") as f:
            f_dict = json.load(f)
        idx = list(range(len(f_dict["filenames"])))
        for empty_idx in sorted(f_dict.get("empty", []), reverse=True):
            idx.remove(empty_idx)
        self._idx = idx
        self._anno = f_dict["annotation"]
        self._filenames = f_dict["filenames"]
        self._image_sizes = f_dict["size"]
        self._object_to_action = f_dict.get(
            "object_to_action", [[a for a in range(self.num_action_cls)]] * self.num_object_cls
        )
        self._actions = f_dict.get("actions", [])
        self._image_ids = f_dict.get("image_ids", list(range(len(f_dict["filenames"]))))

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

    def image_id(self, idx: int) -> int:
        return self._image_ids[self._idx[idx]]

    def image_size(self, idx: int) -> Tuple[int, int]:
        return tuple(self._image_sizes[self._idx[idx]])

    def raw_target(self, idx: int) -> dict:
        return dict(self._anno[self._idx[idx]])

    @property
    def object_to_action(self) -> List[list]:
        return [list(x) for x in self._object_to_action]

    @property
    def actions(self) -> List[str]:
        return list(self._actions)

    def object_verb_mask(self) -> np.ndarray:
        mask = np.zeros((self.num_object_cls, self.num_action_cls), np.float32)
        for obj, acts in enumerate(self._object_to_action):
            for a in acts:
                mask[obj, a] = 1.0
        return mask
