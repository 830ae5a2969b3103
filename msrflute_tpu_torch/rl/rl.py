"""DGA's RL weight hook — the port's counterpart of
``msrflute_tpu/rl/rl.py`` (reference ``extensions/RL/RL.py`` and
``core/strategies/dga.py:286-406``), the host path.

- state: the round's client weights, pseudo-gradient magnitudes, means
  and corrected variances, ``4 * clients_per_round`` values;
- action: :class:`QNet`'s output, epsilon-greedy with an annealed epsilon;
  a random action is ``default_rng(randrange(2**31)).random(K)`` off the
  aggregator's ``random.Random(seed)``, drawn as the JAX package draws it;
- weights ``exp(action)``, non-finite -> 0;
- reward: +1 when the RL-weighted model validates better, 0.1 within
  1e-3 (kept under ``marginal_update_RL``), else -1;
- a DQN step on a replay sample: ``q = sum(net(state) * action)``, mean
  squared error to the reward, through the port's optimizer factory
  (``RL.optimizer_config``) over the net's flat parameter vector;
- the net and its optimizer state in ``rl_<K>.<descriptor>.model`` (a
  ``torch.save`` file), step, epsilon and running loss in ``.stats``.

:class:`QNet` keeps flax's names and layouts (``Dense_<i>.kernel [in,
out]``; with ``wantLSTM`` two ``OptimizedLSTMCell``s, forward and
reversed, with their per-gate ``ii`` ... ``ho`` kernels), so
:func:`..models.convert.qnet_from_flax` carries a flax ``_QNet``'s weights
across by name.
"""

from __future__ import annotations

import json
import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad_and_value

from ..models.base import lecun_normal_
from ..models.nlp import _Dense, _LSTMCell
from ..optim import make_optimizer
from ..utils.logging import print_rank


class QNet(nn.Module):
    """The reference's ``NeuralNetwork`` (``RL.py:79-144``): ReLU layers
    ``sizes[:-1]`` and a linear ``sizes[-1]``; with ``want_lstm`` a
    bidirectional LSTM of ``sizes[0]`` encodes a ``[T, F]`` (or ``[B, T,
    F]``) state window first, its two last states summed."""

    def __init__(self, in_dim: int, sizes: Sequence[int],
                 want_lstm: bool = False):
        super().__init__()
        self.want_lstm = want_lstm
        self.depth = len(sizes)
        d = in_dim
        if want_lstm:
            self.OptimizedLSTMCell_0 = _LSTMCell(in_dim, sizes[0])
            self.OptimizedLSTMCell_1 = _LSTMCell(in_dim, sizes[0])
            d = sizes[0]
        for i, h in enumerate(sizes):
            self.add_module(f"Dense_{i}", _Dense(d, h))
            d = h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.want_lstm:
            squeeze = x.ndim == 2
            if squeeze:
                x = x[None]
            fwd = self.OptimizedLSTMCell_0(x)[:, -1]
            bwd = self.OptimizedLSTMCell_1(x.flip(1))[:, -1]
            x = fwd + bwd
            if squeeze:
                x = x[0]
        for i in range(self.depth - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth - 1}")(x)


class RLAggregator:
    """The epsilon-greedy weight estimator and its DQN, on ``device``."""

    def __init__(self, rl_config, num_clients_per_iteration: int,
                 model_dir: str, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.cfg = rl_config
        self.out_size = int(num_clients_per_iteration)
        self.want_lstm = bool(rl_config.get("wantLSTM", False))
        self.epsilon = float(rl_config.get("initial_epsilon", 0.5))
        self.final_epsilon = float(rl_config.get("final_epsilon", 1e-4))
        self.epsilon_gamma = float(rl_config.get("epsilon_gamma", 0.9))
        self.minibatch = int(rl_config.get("minibatch_size", 16))
        self.max_memory = int(rl_config.get("max_replay_memory_size", 1000))
        self.replay: List[Tuple[np.ndarray, np.ndarray, float]] = []
        self.state_window: List[np.ndarray] = []
        self.running_loss = 0.0
        self.step = 0
        self._pyrng = random.Random(seed)
        self.device = torch.device(device)

        in_dim = 4 * self.out_size
        spec = rl_config.get("network_params") or [in_dim, 128, 128,
                                                   self.out_size]
        if isinstance(spec, str):
            spec = [int(x) for x in spec.split(",")]
        self.net = QNet(in_dim, [int(x) for x in spec[1:]], self.want_lstm)
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.net.named_parameters():
            if name.endswith("kernel"):
                lecun_normal_(p.data, p.shape[0], gen)
        self.names = [n for n, _ in self.net.named_parameters()]
        self.shapes = [p.shape for _, p in self.net.named_parameters()]
        sizes = [p.numel() for _, p in self.net.named_parameters()]
        self.bounds = [0] + list(np.cumsum(sizes))
        self.flat = torch.cat([p.detach().reshape(-1) for p in
                               self.net.parameters()]).to(self.device)
        opt_cfg = rl_config.get("optimizer_config") or {}
        self.opt = make_optimizer(opt_cfg)
        self.lr = float(opt_cfg.get("lr", 0.01))
        self.opt_state = self.opt.init(self.flat)

        descriptor = rl_config.get("model_descriptor_RL", "Default")
        base = rl_config.get("RL_path") or model_dir
        os.makedirs(base, exist_ok=True)
        self.model_name = os.path.join(
            base, f"rl_{self.out_size}.{descriptor}.model")
        self.stats_name = os.path.join(
            base, f"rl_{self.out_size}.{descriptor}.stats")
        self.load_saved_status()

    # ------------------------------------------------------------------
    def params(self, flat: Optional[torch.Tensor] = None):
        """The net's parameters as views into ``flat`` (default: the
        aggregator's own vector)."""
        flat = self.flat if flat is None else flat
        return {n: flat[a:b].view(s) for n, a, b, s in zip(
            self.names, self.bounds[:-1], self.bounds[1:], self.shapes)}

    def load_flax(self, params_np) -> None:
        """Take a flax ``_QNet``'s parameters (nested numpy dict)."""
        from ..models.convert import qnet_from_flax
        named = qnet_from_flax(self.net, params_np)
        self.flat = torch.cat([named[n].reshape(-1) for n in self.names]
                              ).to(self.device)
        self.opt_state = self.opt.init(self.flat)

    def _apply(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.net, self.params(flat), (x,))

    def forward(self, state: np.ndarray) -> np.ndarray:
        """Epsilon-greedy action (reference ``RL.py:183-201``)."""
        state = np.asarray(state, np.float32).reshape(-1)
        if self.want_lstm:
            self.state_window.append(state)
            self.state_window = self.state_window[-self.minibatch:]
            window = np.zeros((self.minibatch, state.shape[0]), np.float32)
            window[-len(self.state_window):] = np.stack(self.state_window)
            state_in = window
        else:
            state_in = state
        if self._pyrng.random() <= self.epsilon:
            print_rank("RL: performed random action")
            action = np.random.default_rng(
                self._pyrng.randrange(2**31)).random(self.out_size)
        else:
            with torch.no_grad():
                action = self._apply(self.flat, torch.from_numpy(
                    state_in).to(self.device)).cpu().numpy()
            if action.ndim > 1:
                action = action[-1]
        return action.astype(np.float32)

    def weights_from_action(self, action: np.ndarray) -> np.ndarray:
        w = np.exp(action.astype(np.float64))
        w[~np.isfinite(w)] = 0.0
        return w.astype(np.float32)

    # ------------------------------------------------------------------
    def dqn_loss(self, flat, states, actions, rewards) -> torch.Tensor:
        q = torch.sum(self._apply(flat, states) * actions, dim=-1)
        return torch.mean((q - rewards) ** 2)

    def train(self, state: np.ndarray, action: np.ndarray,
              reward: float) -> float:
        """One replay DQN step (reference ``RL.py:204-262``)."""
        self.replay.append((np.asarray(state, np.float32).reshape(-1),
                            np.asarray(action, np.float32), float(reward)))
        if len(self.replay) > self.max_memory:
            self.replay.pop(0)
        if self.epsilon * self.epsilon_gamma > self.final_epsilon:
            self.epsilon *= self.epsilon_gamma
        if self.want_lstm:
            batch = self.replay[-self.minibatch:]
        else:
            batch = self._pyrng.sample(
                self.replay, min(len(self.replay), self.minibatch))
        states = np.stack([b[0] for b in batch])
        actions = np.stack([b[1] for b in batch])
        rewards = np.asarray([b[2] for b in batch], np.float32)
        if self.want_lstm:
            # one zero-padded window; Q read at the last step, as forward()
            pad = np.zeros((self.minibatch - len(batch), states.shape[1]),
                           np.float32)
            states = np.concatenate([pad, states])[None]
            actions, rewards = actions[-1:], rewards[-1:]
        dev = self.device
        grads, loss = grad_and_value(self.dqn_loss)(
            self.flat, torch.from_numpy(states).to(dev),
            torch.from_numpy(actions).to(dev),
            torch.from_numpy(rewards).to(dev))
        self.flat, self.opt_state = self.opt.step(
            self.flat, grads, self.opt_state, self.lr, self.bounds)
        loss = float(loss)
        self.running_loss = loss if self.running_loss == 0 else \
            0.95 * self.running_loss + 0.05 * loss
        self.step += 1
        return loss

    # ------------------------------------------------------------------
    def compute_reward(self, baseline_acc: float, rl_acc: float,
                       marginal_update: bool) -> Tuple[float, bool]:
        """Reward and whether to keep the RL model (``dga.py:366-390``)."""
        if abs(baseline_acc - rl_acc) < 0.001:
            return 0.1, bool(marginal_update)
        if rl_acc > baseline_acc:
            return 1.0, True
        return -1.0, False

    # ------------------------------------------------------------------
    def save(self) -> None:
        """Both files by tmp + rename: a crash leaves the last pair."""
        tmp = self.model_name + ".tmp"
        torch.save({"params": self.flat.cpu(),
                    "opt_state": {k: v.cpu() for k, v in
                                  self.opt_state.items()}}, tmp)
        os.replace(tmp, self.model_name)
        tmp = self.stats_name + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"step": self.step, "epsilon": self.epsilon,
                       "running_loss": self.running_loss}, fh)
        os.replace(tmp, self.stats_name)

    def load_saved_status(self) -> None:
        if os.path.exists(self.model_name):
            blob = torch.load(self.model_name, map_location=self.device)
            self.flat = blob["params"]
            self.opt_state = blob["opt_state"]
            print_rank(f"RL: restored model from {self.model_name}")
        if os.path.exists(self.stats_name):
            with open(self.stats_name) as fh:
                stats = json.load(fh)
            self.step = int(stats.get("step", 0))
            self.epsilon = float(stats.get("epsilon", self.epsilon))
            self.running_loss = float(stats.get("running_loss", 0.0))
