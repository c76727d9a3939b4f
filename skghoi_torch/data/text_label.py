"""HICO text-label metadata, generated programmatically (host only).

A copy of ``skghoi_tpu.data.text_label``, which imports nothing of JAX; the
port keeps its own.

The reference ships ``hicodet/hico_text_label.py`` — ~900 lines of static
tables: CLIP-style prompts per (verb, object) pair and per object, class-name
lists, a verb -> valid-object map, and zero-shot unseen-index splits.  Nothing
in the training/eval path consumes them (they serve prompt-based experiments),
so instead of vendoring a second copy of the data this module *derives* the
same structures from dataset metadata:

- pair prompts: "a photo of a person {verb-ing} {article} {object}", with the
  reference's convention of "and" for the no_interaction class;
- object prompts: "a photo of {article} {object}" (+ "a photo of nothing");
- ``hico_unseen_index``-style splits: ``rare_first`` / ``non_rare_first``
  from the per-interaction GT counts; arbitrary custom splits (the uc0..uc4
  lists) load from JSON.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

_VOWELS = "aeiou"
_IRREGULAR_GERUNDS = {
    "no_interaction": "and",
    # final-syllable stress exceptions to the consonant-doubling rule, plus
    # ie -> y (verified verbatim against hico_action_ongoing_classes)
    "exit": "exiting",
    "open": "opening",
    "tie": "tying",
    "cut_with": "cutting with",
    "eat_at": "eating at",
    "sit_at": "sitting at",
    "sit_on": "sitting on",
    "stand_on": "standing on",
    "stand_under": "standing under",
    "lie_on": "lying on",
    "talk_on": "talking on",
    "text_on": "texting on",
    "work_on": "working on",
    "jump_on": "jumping on",
    "hop_on": "hopping on",
    "walk_on": "walking on",
}


def gerund(verb: str) -> str:
    """Best-effort English -ing form for HICO verb tokens (may contain '_')."""
    if verb in _IRREGULAR_GERUNDS:
        return _IRREGULAR_GERUNDS[verb]
    parts = verb.split("_")
    head, rest = parts[0], parts[1:]
    if head.endswith("e") and not head.endswith(("ee", "ye")):
        head = head[:-1] + "ing"
    elif (
        len(head) >= 3
        and head[-1] not in _VOWELS + "wxy"
        and head[-2] in _VOWELS
        and head[-3] not in _VOWELS
    ):
        head = head + head[-1] + "ing"
    else:
        head = head + "ing"
    return " ".join([head] + rest)


def article(noun: str) -> str:
    noun = noun.replace("_", " ").strip()
    # Reference quirk, kept for verbatim parity: "a umbrella" everywhere
    # (hicodet/hico_text_label.py — both the pair and the object prompts).
    if noun == "umbrella":
        return "a"
    return "an" if noun[0] in _VOWELS else "a"


def pair_prompt(verb: str, obj: str) -> str:
    obj_txt = obj.replace("_", " ")
    if verb == "no_interaction":
        return f"a photo of a person and {article(obj_txt)} {obj_txt}"
    return f"a photo of a person {gerund(verb)} {article(obj_txt)} {obj_txt}"


def hico_text_labels(
    class_corr: Sequence[Sequence[int]], verbs: List[str], objects: List[str]
) -> Dict[Tuple[int, int], str]:
    """(verb_idx, object_idx) -> prompt, for every interaction class."""
    return {
        (verb_idx, obj_idx): pair_prompt(verbs[verb_idx], objects[obj_idx])
        for _, obj_idx, verb_idx in class_corr
    }


def hico_obj_text_labels(objects: List[str]) -> List[Tuple[int, str]]:
    out = []
    for i, name in enumerate(objects):
        txt = name.replace("_", " ")
        out.append((i, f"a photo of {article(txt)} {txt}"))
    out.append((len(objects), "a photo of nothing"))
    return out


def verb_to_objects(class_corr: Sequence[Sequence[int]], num_verbs: int) -> List[List[int]]:
    out: List[List[int]] = [[] for _ in range(num_verbs)]
    for _, obj_idx, verb_idx in class_corr:
        out[verb_idx].append(obj_idx)
    return out


def unseen_index_splits(
    anno_interaction: Sequence[int],
    num_unseen: int = 120,
    custom_splits_json: str | None = None,
) -> Dict[str, List[int]]:
    """Zero-shot splits: ``rare_first`` (rarest classes unseen),
    ``non_rare_first`` (most frequent unseen), plus any splits loaded from a
    JSON file (the reference's hand-picked uc0..uc4 lists)."""
    order = sorted(range(len(anno_interaction)), key=lambda i: (anno_interaction[i], i))
    splits = {
        "rare_first": order[:num_unseen],
        "non_rare_first": order[::-1][:num_unseen],
        "default": [],
    }
    if custom_splits_json:
        with open(custom_splits_json) as f:
            splits.update(json.load(f))
    return splits
