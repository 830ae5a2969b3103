"""Weight carry-across between the JAX package and the port.

The JAX package's parameters are a nested dict of arrays in flax layout:
``Conv_*/kernel`` is HWIO ``[kh, kw, in, out]`` and ``Dense_*/kernel`` is
``[in, out]``.  The port names the same leaves ``Conv_*.weight`` (OIHW, as
``torch.nn.Conv2d`` holds it) and ``Dense_*.weight`` (``[out, in]``, as
``torch.nn.Linear`` holds it).  Because the port's CNN flattens NHWC before
``Dense_0`` (see :mod:`.cv`), no input-axis permutation of ``Dense_0`` is
needed: the only layout rule is the per-kernel transpose.

The hello_mlp plugin's MLP (:mod:`..plugins.hello_mlp`, ``Dense_0`` and
``Dense_1``) needs no other rule.  The ResNet (:mod:`.resnet`) follows
the same rule: its convolutions have
no bias, so ``_BasicBlock_3.Conv_2.kernel`` (HWIO) becomes
``_BasicBlock_3.Conv_2.weight`` (OIHW) alone, and GroupNorm's ``scale``
and ``bias`` keep their names and ``[C]`` shapes.

The GRU LM, the Shakespeare LSTM (:mod:`.nlp`), RingLM, ECG_CNN
(:mod:`.ecg`), NRMS (:mod:`.fednewsrec`) and the BERT masked LM
(:mod:`.bert`) keep flax's own names and layouts (``kernel [in, out]``,
nested ``Scan_ConvexGRUCell_0.w_hh.kernel``; the LSTM's gate kernels
``OptimizedLSTMCell_0.ii.kernel`` ... ``.ho.kernel`` with the biases on
the hidden ones, ``Embed_0.embedding``; ECG's 1-D ``Conv_*.kernel`` ``[k,
in, out]``; NRMS's ``SelfAttention_0.query.kernel`` ``[in, heads,
head_dim]``; HF Flax ``FlaxBertForMaskedLM``'s
``bert.encoder.layer.0.attention.self.query.kernel``; RingLM's MoE FFN
``block_<i>.moe_ffn.router [D, E]``, ``w_in [E, D, H]``, ``w_out [E, H,
D]``; the reference FedNewsRec net's ``_RefDocEncoder_0.conv.kernel [3,
in, out]`` and ``_RefUserEncoder_0.GRUCell_0.ir.kernel``): a flax path
that the task names as it is carries across unchanged, and the task lists
its leaves in ``ravel_pytree`` order.  The reference net's frozen word
table is no parameter and is not carried.

DGA's RL weight hook (:class:`..rl.QNet`) keeps flax's names and layouts
too: ``Dense_<i>.kernel [in, out]`` and ``bias``, and with ``wantLSTM``
``OptimizedLSTMCell_0`` (forward) and ``_1`` (reversed) with their
per-gate kernels ``ii`` ... ``io`` and ``hi`` ... ``ho`` (biases on the
hidden ones), which the cell stacks in the order ``i, f, g, o`` when it
runs.  :func:`qnet_from_flax` carries a flax ``_QNet``'s parameters across
by name, and :func:`fused_rl_from_jax` a JAX ``FusedRL`` state (the net,
its optax moments, the replay ring) into the port's flat ``rl.`` entries.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .base import BaseTask

_TORCH_NAME = {"kernel": "weight", "bias": "bias"}
_FLAX_NAME = {v: k for k, v in _TORCH_NAME.items()}


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:          # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 2:          # [in, out] -> [out, in]
        return kernel.T
    raise ValueError(f"unsupported kernel rank {kernel.ndim}")


def _to_flax_layout(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:          # OIHW -> HWIO
        return weight.transpose(2, 3, 1, 0)
    if weight.ndim == 2:
        return weight.T
    raise ValueError(f"unsupported weight rank {weight.ndim}")


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def from_jax_params(task: BaseTask, params_np: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of numpy arrays) -> the port's
    ``{name: float32 CPU tensor}``, checked against the task's shapes."""
    want = dict(task.param_spec())
    out = {}
    for path, value in _flatten(params_np):
        arr = np.asarray(value, dtype=np.float32)
        name = path
        if path not in want:
            layer, leaf = path.rsplit(".", 1)
            name = f"{layer}.{_TORCH_NAME[leaf]}"
            if leaf == "kernel":
                arr = _to_torch_layout(arr)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        raise ValueError(f"parameter shapes {got} do not match task {want}")
    return {name: out[name] for name in want}


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax path of the port's leaf ``name`` (``Dense_0.weight`` ->
    ``("Dense_0", "kernel")``): the keys the JAX package's layer controls
    join, ``/`` for ``freeze_layer`` and ``.`` for ``updatable_layers``."""
    *path, leaf = name.split(".")
    return (*path, _FLAX_NAME.get(leaf, leaf))


def to_jax_params(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`from_jax_params`: the port's tensors -> flax's
    nested dict of numpy arrays."""
    out: Dict[str, Any] = {}
    for name, tensor in params.items():
        *path, leaf = flax_path(name)
        arr = tensor.detach().cpu().numpy()
        if name.split(".")[-1] == "weight":
            arr = np.ascontiguousarray(_to_flax_layout(arr))
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return out


def qnet_from_flax(module: torch.nn.Module, params_np: Dict[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """A flax ``_QNet``'s parameters (nested dict of numpy arrays) ->
    ``{name: float32 CPU tensor}`` in the port's :class:`..rl.QNet`
    ``module``'s names, checked against its shapes."""
    want = {n: tuple(p.shape) for n, p in module.named_parameters()}
    out = {path: torch.from_numpy(np.array(value, dtype=np.float32,
                                           order="C"))
           for path, value in _flatten(params_np)}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        raise ValueError(f"QNet parameter shapes {got} do not match {want}")
    return out


def _optax_moments(opt_state: Any) -> Dict[str, Any]:
    """The moment entries of an optax state (numpy, after
    ``jax.device_get``), by the port's optimizer-state names: a
    ``ScaleByAdamState``'s ``mu``, ``nu`` and ``count``, a ``TraceState``'s
    ``trace``.  Wrappers (``InjectHyperparamsState``, chains) are walked;
    their own step counts and hyperparameters are not state the port
    keeps."""
    found: Dict[str, Any] = {}

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None:
            if "mu" in fields and "nu" in fields:
                found.update(mu=node.mu, nu=node.nu, count=node.count)
                return
            if "trace" in fields:
                found["trace"] = node.trace
                return
            if "inner_state" in fields:
                walk(node.inner_state)
                return
            for value in node:
                walk(value)
        elif isinstance(node, (tuple, list)):
            for value in node:
                walk(value)

    walk(opt_state)
    return found


def fused_rl_from_jax(fused, state_np: Dict[str, Any],
                      device: torch.device = torch.device("cpu")
                      ) -> Dict[str, torch.Tensor]:
    """A JAX ``FusedRL`` state (``init_state`` or a later round's, as
    numpy) -> the ``rl.`` entries of the port's ``strategy_state`` for the
    port's :class:`..rl.fused.FusedRL` ``fused``: the flax net's and its
    optax moments' leaves by name into flat vectors (:func:`qnet_from_flax`
    and the port's parameter order), the ring's entries as they are."""
    net = fused.flatten(qnet_from_flax(fused.net, state_np["net"]))
    template = fused.opt.init(net)
    opt = {}
    moments = _optax_moments(state_np["opt"])
    if set(moments) != set(template):
        raise ValueError(f"optimizer state {sorted(moments)} does not match "
                         f"the port's {sorted(template)}")
    for key, value in moments.items():
        if key == "count":
            opt[key] = torch.as_tensor(np.array(value)).to(
                template[key].dtype)
        else:
            opt[key] = fused.flatten(qnet_from_flax(fused.net, value))
    rest = {k: torch.from_numpy(np.array(state_np[k]))
            for k in ("replay_s", "replay_a", "replay_r", "count", "ptr",
                      "eps", "prev_s", "prev_a", "prev_loss", "have_prev")}
    return fused.state_from(net, opt, device, **rest)
