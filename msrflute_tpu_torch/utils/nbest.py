"""ASR n-best jsonl utilities.

The port's copy of ``msrflute_tpu/utils/nbest.py``: the same softmax
and byte-equal JSONL files.

Parity target: reference ``utils/utils.py:362-483`` — helpers used by the
(legacy) ASR tasks to dump n-best hypotheses as a jsonl manifest with
softmax-renormalized per-hypothesis loss weights, and the numerically-stable
``softmax`` helper (``utils/utils.py:78-114``).
"""

from __future__ import annotations

import copy
import json
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from .logging import print_rank


def softmax(x: np.ndarray, axis: Optional[int] = None) -> np.ndarray:
    """Stable softmax (reference ``utils/utils.py:78-114``).  Like the
    reference, the default axis is the first NON-singleton one (a (1, n)
    row vector normalizes over n, not elementwise); 1-D inputs stay 1-D."""
    x = np.asarray(x, np.float64)
    if axis is None:
        axis = next((i for i, n in enumerate(x.shape) if n > 1), 0) \
            if x.ndim > 0 else 0
    shifted = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(shifted)
    return e / np.sum(e, axis=axis, keepdims=True)


def write_nbest_jsonl(uttid2jsonl: Dict[str, dict],
                      uttid2hypos: Dict[str, Sequence[Sequence[str]]],
                      uttid2scores: Dict[str, np.ndarray],
                      outputpath: str, nbest: int,
                      orgpath: str = "", newpath: str = "") -> bool:
    """Dump a jsonl manifest with n-best hypotheses (reference
    ``write_nbest_jsonl``): each utterance expands into ``nbest`` entries
    ``<uttid>-<n>`` whose ``loss_weight`` is the softmax of the n-best
    scores; missing hypotheses are back-filled from the 1-best; ``wav``
    paths are rewritten from ``orgpath`` to ``newpath``."""
    records: List[dict] = []
    for uttid, base in uttid2jsonl.items():
        if uttid not in uttid2hypos:
            print_rank(f"Missing utterance {uttid} in results",
                       loglevel=logging.WARNING)
            continue
        hypos = uttid2hypos[uttid]
        if len(hypos) == 0:
            print_rank(f"Empty hypotheses for {uttid}; skipping",
                       loglevel=logging.WARNING)
            continue
        if nbest > 1:
            scores = np.asarray(uttid2scores.get(uttid, []), np.float64)
            if scores.size:
                weights = scores
                while len(weights) < nbest:
                    print_rank(f"Missing {len(weights)}-th best result in "
                               f"{uttid}; appending 1-best score")
                    weights = np.append(weights, weights[0])
                weights = softmax(weights[:nbest]).reshape(-1)
            else:
                weights = np.ones(nbest) / nbest
            for n in range(nbest):
                hypo = hypos[n] if n < len(hypos) else hypos[0]
                rec = copy.deepcopy(base)
                rec["id"] = f"{uttid}-{n}"
                rec["text"] = " ".join(hypo)
                rec["loss_weight"] = float(weights[n])
                records.append(rec)
        else:
            rec = copy.deepcopy(base)
            rec["id"] = uttid
            rec["text"] = " ".join(hypos[0])
            records.append(rec)

    with open(outputpath, "w") as fh:
        for rec in records:
            if "wav" in rec and orgpath:
                rec["wav"] = rec["wav"].replace(orgpath, newpath)
            fh.write(json.dumps(rec) + "\n")
    return True
