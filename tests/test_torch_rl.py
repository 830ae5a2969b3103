"""DGA's RL weight hook against the JAX package (``msrflute_tpu/rl/rl.py``
and ``engine/server.py::_run_rl_round``):

- the Q-network with its weights carried across from flax
  (``models/convert.py::qnet_from_flax``) gives flax's outputs, and the
  DQN's training losses over a replay sequence match: ``rel 1e-5`` for
  the MLP head, ``rel 1e-4`` for the bidirectional-LSTM head;
- 6 rounds of LR under DGA with ``wantRL``, the two servers from the same
  initial weights, seed and Q-network: the same actions (random and
  greedy), weights, rewards and kept candidate every round, and val loss
  at ``rel 1e-5``;
- the aggregator's save and load restore its network, optimizer state and
  schedule.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import RLConfig as JaxRLConfig
from msrflute_tpu.rl import RLAggregator as JaxRLAggregator
from msrflute_tpu_torch.config import RLConfig
from msrflute_tpu_torch.rl import RLAggregator

from test_torch_strategies import (jax_history, lr_config, port_cli_history,
                                   write_lr_blob)


def _pair(raw, tmp_path, out=4):
    jrl = JaxRLAggregator(JaxRLConfig.from_dict(copy.deepcopy(raw)), out,
                          str(tmp_path / "jax"), seed=0)
    prl = RLAggregator(RLConfig.from_dict(copy.deepcopy(raw)), out,
                       str(tmp_path / "port"), seed=0)
    prl.load_flax(jax.device_get(jrl.params))
    return jrl, prl


@pytest.mark.parametrize("lstm,rel", [(False, 1e-5), (True, 1e-4)])
@pytest.mark.parametrize("opt", [{"type": "sgd", "lr": 0.05},
                                 {"type": "adam", "lr": 0.01}])
def test_dqn_matches_jax(lstm, rel, opt, tmp_path):
    raw = {"wantLSTM": lstm, "minibatch_size": 3, "initial_epsilon": 0.5,
           "network_params": [16, 12, 10, 4], "optimizer_config": opt}
    jrl, prl = _pair(raw, tmp_path)
    rng = np.random.default_rng(0)
    states = rng.normal(size=(7, 16)).astype(np.float32)
    # the network's outputs on one state and on a window of states
    window = states[:3] if lstm else states[0]
    np.testing.assert_allclose(
        prl._apply(prl.flat, torch.from_numpy(window)).detach().numpy(),
        np.asarray(jrl._forward(jrl.params, jnp.asarray(window))),
        rtol=rel, atol=1e-6)
    for t in range(7):
        action = rng.random(4).astype(np.float32)
        reward = float(rng.choice([1.0, 0.1, -1.0]))
        want = jrl.train(states[t], action, reward)
        got = prl.train(states[t], action, reward)
        assert abs(got - want) <= rel * abs(want), (t, got, want)
    assert prl.epsilon == jrl.epsilon and prl.step == jrl.step
    assert abs(prl.running_loss - jrl.running_loss) <= \
        rel * abs(jrl.running_loss)


def test_random_and_greedy_actions_match_jax(tmp_path):
    jrl, prl = _pair({"initial_epsilon": 0.5, "network_params":
                      [16, 8, 4]}, tmp_path)
    rng = np.random.default_rng(1)
    for _ in range(12):
        s = rng.normal(size=16).astype(np.float32)
        np.testing.assert_allclose(prl.forward(s), jrl.forward(s),
                                   rtol=1e-5, atol=1e-6)
    w = prl.weights_from_action(np.asarray([0.0, 1.0, 1e4, np.nan],
                                           np.float32))
    np.testing.assert_array_equal(
        w, jrl.weights_from_action(np.asarray([0.0, 1.0, 1e4, np.nan],
                                              np.float32)))
    for base, rl_acc in ((0.5, 0.5005), (0.5, 0.6), (0.5, 0.4)):
        for marginal in (True, False):
            assert prl.compute_reward(base, rl_acc, marginal) == \
                jrl.compute_reward(base, rl_acc, marginal)


def test_save_and_load_restore_the_aggregator(tmp_path):
    raw = {"network_params": [16, 8, 4], "optimizer_config":
           {"type": "adam", "lr": 0.01}}
    prl = RLAggregator(RLConfig.from_dict(raw), 4, str(tmp_path), seed=0)
    rng = np.random.default_rng(2)
    for _ in range(3):
        prl.train(rng.normal(size=16), rng.random(4), 1.0)
    prl.save()
    again = RLAggregator(RLConfig.from_dict(raw), 4, str(tmp_path), seed=1)
    assert torch.equal(again.flat, prl.flat)
    assert all(torch.equal(v, prl.opt_state[k])
               for k, v in again.opt_state.items())
    assert (again.step, again.epsilon, again.running_loss) == \
        (prl.step, prl.epsilon, prl.running_loss)


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("rl_blob")
    write_lr_blob(d / "train.json", 16, 6, 24, seed=7)
    write_lr_blob(d / "val.json", 4, 6, 24, seed=8)
    return str(d)


class _Recorder:
    """Wraps an aggregator's ``forward`` and ``compute_reward``."""

    def __init__(self, rl):
        self.actions, self.rewards = [], []
        forward, reward = rl.forward, rl.compute_reward

        def rec_forward(state):
            self.actions.append(forward(state))
            return self.actions[-1]

        def rec_reward(base, acc, marginal):
            out = reward(base, acc, marginal)
            self.rewards.append((base, acc) + tuple(out))
            return out

        rl.forward, rl.compute_reward = rec_forward, rec_reward


def test_rl_rounds_match_jax(lr_blob, tmp_path, monkeypatch):
    raw = lr_config("dga", server={
        "wantRL": True, "aggregate_median": "softmax", "softmax_beta": 1.0,
        "RL": {"initial_epsilon": 0.6, "epsilon_gamma": 0.8,
               "minibatch_size": 4, "network_params": [16, 32, 4],
               "optimizer_config": {"type": "sgd", "lr": 0.05}}})
    from msrflute_tpu_torch.engine import server as port_server_mod
    from msrflute_tpu.engine import server as jax_server_mod
    recs = {}

    def recording_init(cls, key):
        init = cls.__init__

        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            recs[key] = (self, _Recorder(self.rl))
        return wrapped

    jax_cls = jax_server_mod.OptimizationServer
    monkeypatch.setattr(jax_cls, "__init__", recording_init(jax_cls, "jax"))
    init, want, n_val = jax_history(raw, lr_blob, str(tmp_path / "jax"))
    jserver, jrec = recs["jax"]

    port_cls = port_server_mod.OptimizationServer
    port_init = recording_init(port_cls, "port")

    def carried(self, *a, **kw):
        port_init(self, *a, **kw)
        # the JAX server's Q-network as it started (its optimizer is SGD
        # without state, so the start is the same)
        self.rl.load_flax(jserver_start)

    # the flax Q-network before training: rebuild the JAX aggregator's
    # init, which depends on the seed alone
    jserver_start = jax.device_get(JaxRLAggregator(
        jserver.rl.cfg, 4, str(tmp_path / "jax_init"), seed=0).params)
    monkeypatch.setattr(port_cls, "__init__", carried)
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    _, prec = recs["port"]
    assert len(prec.actions) == len(jrec.actions) == 6
    for a, b in zip(prec.actions, jrec.actions):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(server.rl.weights_from_action(a),
                                   jserver.rl.weights_from_action(b),
                                   rtol=1e-5)
    for (pb, pa, pr, pk), (jb, ja, jr, jk) in zip(prec.rewards,
                                                  jrec.rewards):
        assert (pr, pk) == (jr, jk)
        assert abs(pb - jb) * n_val <= 1.0 + 1e-9
        assert abs(pa - ja) * n_val <= 1.0 + 1e-9
    assert server.rl_kept == [r[3] for r in jrec.rewards]
    assert len(got) == len(want) == 7
    for (r, gl, _), (_, wl, _) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
    assert abs(server.rl.running_loss - jserver.rl.running_loss) <= \
        1e-5 * abs(jserver.rl.running_loss)
