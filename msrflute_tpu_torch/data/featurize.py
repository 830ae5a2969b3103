"""Featurization — the port's own copy of ``to_image``, the Shakespeare char
table with ``encode_chars``, ``load_vocab``, ``encode_words`` and
``pad_token_matrix`` from ``msrflute_tpu/data/featurize.py``."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np


def to_image(x: np.ndarray, example_shape: Sequence[int]) -> np.ndarray:
    """Reshape flat/CHW/HW samples to the task's example shape.

    Dtype-preserving: uint8 pixels stay uint8 (models normalize on the
    device, see ``models.base.to_float_image``); integer pixel values in
    [0, 255] become uint8; anything else becomes float32.
    """
    x = np.asarray(x)
    if x.dtype != np.uint8:
        if x.dtype.kind in "iu" and x.size and 0 <= x.min() and x.max() <= 255:
            x = x.astype(np.uint8)
        else:
            x = x.astype(np.float32)
    target = tuple(example_shape)
    n = x.shape[0]
    if x.shape[1:] == target:
        return x
    if x.ndim == 4 and x.shape[1] in (1, 3) and \
            (x.shape[2], x.shape[3], x.shape[1]) == target:
        return np.transpose(x, (0, 2, 3, 1))   # CHW -> HWC
    if x.ndim == 3 and x.shape[1:] + (1,) == target:
        return x[..., None]                    # HW -> HW1
    if int(np.prod(x.shape[1:])) == int(np.prod(target)):
        return x.reshape((n,) + target)
    raise ValueError(f"cannot reshape samples {x.shape} to {target}")


# FedML/LEAF Shakespeare symbol table: pad=0, then letters; OOV maps to the
# last id.  86 printable symbols -> vocab 90 with room for specials.
SHAKESPEARE_LETTERS = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "[]abcdefghijklmnopqrstuvwxyz}"
)
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(SHAKESPEARE_LETTERS)}


def encode_chars(text: str, seq_len: int, oov_id: int = 87) -> np.ndarray:
    """Unpadded char ids (pad to a matrix with :func:`pad_token_matrix`)."""
    return np.asarray([_CHAR_TO_ID.get(c, oov_id) for c in text[:seq_len]],
                      np.int64)


def load_vocab(path: str) -> Dict[str, int]:
    """Word vocab from a json dict / json list / newline list (reference
    ``experiments/nlg_gru/utils/utility.py:19-33``)."""
    with open(path) as fh:
        if path.endswith(".json"):
            raw = json.load(fh)
            if isinstance(raw, dict):
                if "vocab" in raw and isinstance(raw["vocab"], dict):
                    raw = raw["vocab"]
                return {str(w): int(i) for w, i in raw.items()}
            return {str(w): i for i, w in enumerate(raw)}
        return {line.strip(): i for i, line in enumerate(fh) if line.strip()}


def encode_words(text_or_tokens, vocab: Dict[str, int], seq_len: int,
                 unk_id: int = 0) -> np.ndarray:
    """Case-backoff word encoding: the word, else its lowercase, else the
    unk id 0, which is a real token and not padding (reference
    ``experiments/nlg_gru/dataloaders/dataset.py:37-47``)."""
    tokens = (text_or_tokens.split() if isinstance(text_or_tokens, str)
              else list(text_or_tokens))
    ids = []
    for tok in tokens[:seq_len]:
        tok = str(tok)
        if tok in vocab:
            ids.append(vocab[tok])
        elif tok.lower() in vocab:
            ids.append(vocab[tok.lower()])
        else:
            ids.append(unk_id)
    return np.asarray(ids, np.int64)


def pad_token_matrix(seqs: List[np.ndarray], seq_len: int):
    """``(ids [n, L] int32, tok_mask [n, L] float32)``: negative ids mark
    padding (reference ``nlg_gru/model.py:88-91``) and map to 0 with mask
    0, while a real unk id 0 keeps mask 1."""
    out = np.zeros((len(seqs), seq_len), np.int32)
    mask = np.zeros((len(seqs), seq_len), np.float32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.int64).reshape(-1)[:seq_len]
        real = s >= 0
        out[i, :len(s)] = np.where(real, s, 0)
        mask[i, :len(s)] = real.astype(np.float32)
    return out, mask
