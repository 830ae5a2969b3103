"""msrflute_tpu_torch — the PyTorch / CUDA port of msrflute_tpu.

A FLUTE-style federated-learning simulation on one NVIDIA GPU: sample a
cohort, run every client's local SGD over a padded ``[K, S, B]`` grid,
weight and combine the pseudo-gradients through a strategy, step the
server optimizer, evaluate, checkpoint and resume.

The module layout mirrors ``msrflute_tpu`` so each port module sits at the
same relative path as its JAX counterpart.  The package imports neither
JAX nor anything of ``msrflute_tpu``: where the JAX package's host code is
free of JAX (config, data helpers, checksums) this package keeps its own
trimmed copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``-device cpu``); see :mod:`msrflute_tpu_torch.device`.
"""

__all__ = ["device"]
