"""Privacy-attack metrics — the port's counterpart of
``msrflute_tpu/privacy/attacks.py`` (reference
``extensions/privacy/metrics.py``), for all K clients of a round at once.

- :func:`extract_indices_from_embeddings`: the embedding rows of the
  tokens a client trained on get the larger pseudo-gradient norms; rank
  the rows by norm (a STABLE descending order, as ``jnp.argsort(-norms)``:
  rows that got no gradient tie at 0 and keep their index order), call
  the top ``num_tokens`` extracted, and measure their overlap with the
  client's real (non-pad) tokens.
- :func:`practical_epsilon_leakage`: per-token log-probabilities of the
  client's own batches under the round's global model (``pre``) and after
  one attacker step on the client's pseudo-gradient (``post``; the
  configured optimizer, adamax at 0.03 in ``experiments/mlm_bert``); the
  leakage is the largest ``clamp((pre + tol) / (post + tol), 0,
  max_ratio)`` over the real tokens, optionally weighted by
  ``max(exp(pre), exp(post))``, reported as ``max(log(leakage), 0)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.func import vmap

from ..optim import make_optimizer


def extract_indices_from_embeddings(pg_embed: torch.Tensor,
                                    tokens: torch.Tensor,
                                    num_tokens: Optional[torch.Tensor] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pg_embed [K, V, E]`` (each client's pseudo-gradient of the
    embedding table), ``tokens [K, ...]`` (ids <= 0 are padding) and
    ``num_tokens [K]`` (each client's real token count; the grid size by
    default) -> ``(overlap [K], extracted [K, V])``, ``extracted`` a 0/1
    mask of the rows ranked below ``min(num_tokens, V)``."""
    K, V = pg_embed.shape[:2]
    flat = tokens.reshape(K, -1).long()
    valid = (flat > 0).to(torch.float32)
    if num_tokens is None:
        num_tokens = torch.full((K,), float(flat.shape[1]),
                                device=flat.device)
    norms = torch.sqrt(torch.sum(pg_embed * pg_embed, dim=-1))
    order = torch.argsort(-norms, dim=-1, stable=True)
    ranks = torch.empty_like(norms).scatter_(
        -1, order, torch.arange(V, dtype=norms.dtype,
                                device=norms.device).expand(K, V))
    extracted = (ranks < torch.clamp(num_tokens, max=float(V))[:, None]
                 ).to(torch.float32)
    hit = torch.gather(extracted, 1, torch.clamp(flat, 0, V - 1)) * valid
    overlap = hit.sum(-1) / torch.clamp(valid.sum(-1), min=1.0)
    return overlap, extracted


def practical_epsilon_leakage(global_params: Dict[str, torch.Tensor],
                              global_flat: torch.Tensor,
                              pseudo_grad: torch.Tensor, task, layout,
                              arrays: Dict[str, torch.Tensor],
                              sample_mask: torch.Tensor,
                              is_weighted: bool = True,
                              max_ratio: float = 1e9,
                              attacker_optimizer_config=None
                              ) -> torch.Tensor:
    """Perplexity-ratio leakage of each client's update -> ``[K]``.

    ``global_params`` are the round's global views of ``global_flat
    [P]``; ``pseudo_grad [K, P]``; ``arrays`` and ``sample_mask`` the
    round's ``[K, S, B, ...]`` grid.  ``task.token_logprobs(params,
    batch) -> (logp, mask)`` scores one batch.  The attacker takes one
    step of its optimizer (fresh state, ``lr`` of its config) with the
    pseudo-gradient as the gradient."""
    if attacker_optimizer_config is None:
        from ..config import OptimizerConfig
        attacker_optimizer_config = OptimizerConfig(type="adamax", lr=0.03)
    opt = make_optimizer(attacker_optimizer_config)
    lr = float(attacker_optimizer_config.get("lr", 0.01))
    start = global_flat.expand_as(pseudo_grad)
    attacked, _ = opt.step(start, pseudo_grad, opt.init(start), lr,
                           list(layout.offsets) + [layout.numel])
    tol = 1.0 / max_ratio
    S = sample_mask.shape[1]

    def score(params, in_dim):
        fn = vmap(task.token_logprobs, in_dims=(in_dim, 0))
        lps, masks = [], []
        for s in range(S):
            batch = {k: v[:, s] for k, v in arrays.items()}
            batch["sample_mask"] = sample_mask[:, s]
            lp, m = fn(params, batch)
            lps.append(lp.flatten(1))
            masks.append(m.flatten(1))
        return torch.cat(lps, 1), torch.cat(masks, 1)

    pre, mask = score(global_params, None)
    post, _ = score(layout.views(attacked), 0)
    leak = torch.clamp((pre + tol) / (post + tol), 0.0, max_ratio)
    if is_weighted:
        leak = torch.maximum(torch.exp(pre), torch.exp(post)) * leak
    leak = torch.where(mask > 0, leak, torch.full_like(leak, -float("inf")))
    top = torch.amax(leak, dim=-1)
    return torch.clamp(torch.log(torch.clamp(top, min=1e-30)), min=0.0)
