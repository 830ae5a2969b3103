"""Fused RL — the DQN aggregation-weight tuner as device-resident carry, the
port's counterpart of ``msrflute_tpu/rl/fused.py`` (``FusedRL``), for
``server_config.wantRL`` with ``fused_carry``.

The host RL path (:mod:`.rl`, ``engine/server.py::_run_rl_round``)
aggregates twice a round, validates both candidates and rewards the
policy from the comparison: three host reads a round.  Here the whole
tuner — the Q-network's flat parameters, its optimizer state, the replay
ring, epsilon and the delayed experience — rides ``strategy_state`` under
``rl.`` keys (one level of named tensors, as the checkpoint keeps them),
and one call of :meth:`FusedRL.combine` a round, in the round's own
dispatch:

- finishes last round's experience with its delayed reward, the
  round-over-round train-loss change discretized as the host reward is
  (+1 improved, 0.1 within 1e-3, -1 worse);
- pushes it into the replay ring and takes one DQN step on a minibatch
  drawn from it (a no-op until the ring holds an experience);
- picks this round's action epsilon-greedily, epsilon annealed on the
  device, and re-weights the clients' payload stack by ``exp(action)``
  (non-finite -> 0, gated on the strategy's weight).

The reward is the train loss, one round late, not the host path's
validation comparison; the RL weights are always applied.  That is the
JAX package's trade, kept on purpose: nothing is read back, so RL rides
the dispatch ring.  The draws (the explore coin, the random action, the
minibatch indices) come from a generator seeded from the round's server
stream, through :meth:`FusedRL.draws`, which a caller may replace by its
own draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call, grad_and_value

from ..models.base import lecun_normal_
from ..optim import make_optimizer
from .rl import QNet

State = Dict[str, torch.Tensor]
#: the tuner's keys in ``strategy_state``
PREFIX = "rl."


class FusedRL:
    """The in-round DQN weight tuner over a fixed ``K``-client cohort."""

    #: per-client features: weight, magnitude, mean, variance
    #: (``dga.py:305``'s state layout)
    N_FEATS = 4

    def __init__(self, rl_config, cohort_k: int):
        self.cfg = rl_config
        self.k = int(cohort_k)
        self.in_dim = self.N_FEATS * self.k
        self.eps0 = float(rl_config.get("initial_epsilon", 0.5))
        self.final_eps = float(rl_config.get("final_epsilon", 1e-4))
        self.eps_gamma = float(rl_config.get("epsilon_gamma", 0.9))
        self.minibatch = int(rl_config.get("minibatch_size", 16))
        self.max_memory = int(rl_config.get("max_replay_memory_size", 1000))
        spec = rl_config.get("network_params") or [self.in_dim, 128, 128,
                                                   self.k]
        if isinstance(spec, str):
            spec = [int(x) for x in spec.split(",")]
        sizes = [int(x) for x in spec[1:]]
        if sizes[-1] != self.k:
            raise ValueError(
                f"fused RL network_params output size {sizes[-1]} != "
                f"padded cohort size {self.k}")
        self.net = QNet(self.in_dim, sizes)
        self.names = [n for n, _ in self.net.named_parameters()]
        self.shapes = [tuple(p.shape) for _, p in self.net.named_parameters()]
        self.bounds = [0] + list(np.cumsum(
            [int(np.prod(s)) for s in self.shapes]))
        opt_cfg = rl_config.get("optimizer_config") or {}
        self.opt = make_optimizer(opt_cfg)
        self.lr = float(opt_cfg.get("lr", 0.01))

    # ------------------------------------------------------------------
    def flatten(self, named: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The net's parameters (by name) as one flat vector."""
        return torch.cat([named[n].reshape(-1).to(torch.float32)
                          for n in self.names])

    def params(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: flat[a:b].view(s) for n, a, b, s in zip(
            self.names, self.bounds[:-1], self.bounds[1:], self.shapes)}

    def apply(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self.net, self.params(flat), (x,))

    def init_state(self, seed: int, device: torch.device) -> State:
        """A fresh tuner: LeCun-normal kernels from ``seed``, zero biases
        (flax ``nn.Dense``'s init law), an empty replay ring."""
        gen = torch.Generator().manual_seed(int(seed))
        named = {}
        for name, shape in zip(self.names, self.shapes):
            t = torch.zeros(shape)
            if name.endswith("kernel"):
                lecun_normal_(t, shape[0], gen)
            named[name] = t
        return self.state_from(self.flatten(named).to(device), None, device)

    def state_from(self, net: torch.Tensor, opt: Optional[State],
                   device: torch.device, **rest: torch.Tensor) -> State:
        """The ``rl.`` entries of ``strategy_state``: the flat net, its
        optimizer state (fresh when ``opt`` is None) and the ring; any of
        the ring's entries may be given in ``rest``."""
        m, f32 = self.max_memory, torch.float32
        state = {
            "net": net,
            "replay_s": torch.zeros((m, self.in_dim), dtype=f32),
            "replay_a": torch.zeros((m, self.k), dtype=f32),
            "replay_r": torch.zeros(m, dtype=f32),
            "count": torch.zeros((), dtype=torch.int32),
            "ptr": torch.zeros((), dtype=torch.int32),
            "eps": torch.tensor(self.eps0, dtype=f32),
            # last round's (state, action, loss), rewarded this round
            "prev_s": torch.zeros(self.in_dim, dtype=f32),
            "prev_a": torch.zeros(self.k, dtype=f32),
            "prev_loss": torch.zeros((), dtype=f32),
            "have_prev": torch.zeros((), dtype=f32),
        }
        state.update(rest)
        opt = self.opt.init(net) if opt is None else opt
        state.update({f"opt.{k}": v for k, v in opt.items()})
        return {PREFIX + k: v.to(device) for k, v in state.items()}

    @staticmethod
    def split(strategy_state: State) -> Tuple[State, State]:
        """``(the strategy's own entries, the tuner's without prefix)``."""
        base = {k: v for k, v in strategy_state.items()
                if not k.startswith(PREFIX)}
        rl = {k[len(PREFIX):]: v for k, v in strategy_state.items()
              if k.startswith(PREFIX)}
        return base, rl

    # ------------------------------------------------------------------
    def draws(self, gen: torch.Generator, count: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        """The round's random draws on the generator's device: the explore
        coin (uniform, compared with epsilon), the random action (``K``
        uniforms) and the minibatch's ring indices, uniform over the
        ``max(count, 1)`` filled slots (``count`` stays on the device)."""
        dev = count.device
        coin = torch.rand((), generator=gen, device=dev)
        action = torch.rand(self.k, generator=gen, device=dev)
        u = torch.rand(self.minibatch, generator=gen, device=dev)
        n = torch.clamp(count, min=1).to(torch.int64)
        idx = torch.minimum((u * n.to(torch.float32)).to(torch.int64), n - 1)
        return {"coin": coin, "rand_action": action, "idx": idx}

    def combine(self, strategy_state: State, per_client: State,
                stack: torch.Tensor, cur_loss: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, State, Dict[str, torch.Tensor]]:
        """One round of the tuner: delayed reward, replay push, DQN step,
        epsilon-greedy action, re-weighted aggregate.  ``per_client``:
        ``{"w", "mag", "mean", "var"}``, each ``[K]``; ``stack``: the
        payloads ``[K, P]``; ``cur_loss``: the round's mean train loss.
        ``draws`` replaces :meth:`draws` on ``gen``.  Returns ``(aggregate,
        new strategy_state, stats)``."""
        base, st = self.split(strategy_state)
        w = per_client["w"]
        k_act = int(w.shape[0])
        if k_act > self.k:
            raise ValueError(
                f"fused RL cohort {k_act} exceeds the configured "
                f"num_clients_per_iteration grid ({self.k})")
        pad = self.k - k_act   # a pool smaller than the cohort: zero feats
        state_vec = torch.cat([
            torch.nn.functional.pad(per_client[f].to(torch.float32),
                                    (0, pad))
            for f in ("w", "mag", "mean", "var")])
        state_vec = torch.nan_to_num(state_vec, nan=0.0, posinf=0.0,
                                     neginf=0.0)

        # the delayed reward for last round's action
        have = st["have_prev"]
        delta = st["prev_loss"] - cur_loss
        reward = torch.where(torch.abs(delta) < 1e-3, 0.1,
                             torch.where(delta > 0, 1.0, -1.0)) * have
        # the push, written only once an experience exists (the slot's
        # own row again otherwise)
        slot = st["ptr"].to(torch.int64).reshape(1)
        pushed_b = have > 0

        def push(ring, row):
            old = ring.index_select(0, slot)
            new = torch.where(pushed_b, row.reshape(old.shape), old)
            return ring.index_copy(0, slot, new)

        replay_s = push(st["replay_s"], st["prev_s"])
        replay_a = push(st["replay_a"], st["prev_a"])
        replay_r = push(st["replay_r"], reward)
        pushed = pushed_b.to(torch.int32)
        count = torch.clamp(st["count"] + pushed, max=self.max_memory)
        ptr = torch.remainder(st["ptr"] + pushed, self.max_memory)

        if draws is None:
            draws = self.draws(gen, count)
        # one DQN step on the minibatch, kept once the ring is not empty
        idx = draws["idx"].to(torch.int64)
        bs, ba, br = (replay_s.index_select(0, idx),
                      replay_a.index_select(0, idx),
                      replay_r.index_select(0, idx))

        def loss_fn(flat):
            q = torch.sum(self.apply(flat, bs) * ba, dim=-1)
            return torch.mean((q - br) ** 2)

        net = st["net"]
        opt_state = {k[len("opt."):]: v for k, v in st.items()
                     if k.startswith("opt.")}
        grads, qloss = grad_and_value(loss_fn)(net)
        stepped, new_opt = self.opt.step(net, grads, opt_state, self.lr,
                                         self.bounds)
        live = count > 0
        new_net = torch.where(live, stepped, net)
        new_opt = {k: torch.where(live, v, opt_state[k])
                   for k, v in new_opt.items()}
        qloss = qloss * live.to(torch.float32)

        # this round's action, epsilon-greedy
        explore = draws["coin"] <= st["eps"]
        with torch.no_grad():
            net_action = self.apply(new_net, state_vec)
        action = torch.where(explore, draws["rand_action"], net_action)
        # exp(action), non-finite -> 0; padding and dropped clients stay
        # out through the strategy's weight
        rl_w = torch.nan_to_num(torch.exp(action[:k_act]), nan=0.0,
                                posinf=0.0, neginf=0.0) \
            * (w > 0).to(torch.float32)
        denom = torch.clamp(torch.sum(rl_w), min=1e-12)
        agg = (rl_w.to(stack.dtype) @ stack) / denom.to(stack.dtype)

        eps = st["eps"]
        new_eps = torch.where(eps * self.eps_gamma > self.final_eps,
                              eps * self.eps_gamma, eps)
        new = dict(st, net=new_net, replay_s=replay_s, replay_a=replay_a,
                   replay_r=replay_r, count=count, ptr=ptr, eps=new_eps,
                   prev_s=state_vec, prev_a=action.detach(),
                   prev_loss=cur_loss.to(torch.float32),
                   have_prev=torch.ones_like(have))
        new.update({f"opt.{k}": v for k, v in new_opt.items()})
        out = dict(base)
        out.update({PREFIX + k: v.detach() for k, v in new.items()})
        stats = {"rl_reward": reward, "rl_qloss": qloss.detach(),
                 "rl_epsilon": eps, "rl_explored": explore.to(torch.float32)}
        return agg, out, stats

