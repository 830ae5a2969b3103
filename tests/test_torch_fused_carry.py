"""``server_config.fused_carry`` in the port — SCAFFOLD's and EF's carry
modes, fused RL and personalization's carry — against the JAX package
(``msrflute_tpu/strategies/{scaffold,ef_quant,personalized}.py``,
``rl/fused.py``, ``engine/round.py``'s carry gather and scatter), on
``tests/test_universal_overlap.py``'s setup: LR, 4 classes, ``input_dim``
8, 4 clients a round, 6 rounds, ``conftest.make_synthetic_classification``.

- Each leg through the JAX server and the port's server from the same
  data and initial weights (fused RL's tuner carried across with
  :func:`~msrflute_tpu_torch.models.convert.fused_rl_from_jax`): final
  params and carry tables ``rtol 1e-5``, val loss ``rel 1e-5`` each
  round, accuracy to one val sample (``tests/test_torch_strategies.py``'s
  bars).  The RL leg runs with ``initial_epsilon: 0`` and a one-slot
  replay ring, so its random draws (which the two packages take from
  different streams) decide nothing; :func:`test_fused_rl_combine_
  matches_jax` holds the draws' uses with the JAX draws handed in.
- The port at depth 1 and 2 against depth 0, bitwise, having pipelined;
  fused SCAFFOLD and EF against the port's host rounds, bitwise; each
  leg with chaos at depth 1 against depth 0, bitwise; each leg cut
  after round 3 and resumed to 6, bitwise, ``strategy_state`` included.
- EF's carry step: the payload and the new residual rows bitwise the JAX
  plain path's on the same ``corrected``, and the scatter the JAX
  ``mode="drop"`` scatter's.
- The personalized eval reads the tables: the same result twice, the JAX
  package's at ``rel 1e-5``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from conftest import make_synthetic_classification
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import RLConfig as JaxRLConfig
from msrflute_tpu.engine.server import select_server as jax_select_server
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.rl.fused import FusedRL as JaxFusedRL
from msrflute_tpu.strategies import select_strategy as jax_select_strategy
from msrflute_tpu_torch.config import FLUTEConfig, RLConfig
from msrflute_tpu_torch.data.dataset import ArraysDataset
from msrflute_tpu_torch.engine.server import select_server
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import (from_jax_params,
                                               fused_rl_from_jax)
from msrflute_tpu_torch.rl.fused import PREFIX, FusedRL
from msrflute_tpu_torch.strategies import select_strategy

ROUNDS = 6
LOSS_REL = 1e-5
LEGS = ("scaffold", "ef_quant", "rl", "personalization")
CHAOS = {"enable": True, "seed": 3, "dropout_rate": 0.25,
         "straggler_rate": 0.25}


def raw_config(leg, depth=1, fused=True, rounds=ROUNDS, val_freq=100,
               chaos=None, **server_over):
    """``test_universal_overlap.py::_cfg``'s config for ``leg``."""
    sc = {"max_iteration": rounds, "num_clients_per_iteration": 4,
          "initial_lr_client": 0.2, "pipeline_depth": depth,
          "fused_carry": fused, "rounds_per_step": 1,
          "val_freq": val_freq, "initial_val": val_freq < 100,
          "optimizer_config": {"type": "sgd", "lr": 1.0},
          "data_config": {"val": {"batch_size": 8}}}
    cc = {"optimizer_config": {"type": "sgd", "lr": 0.2},
          "data_config": {"train": {"batch_size": 4}}}
    strategy = leg
    if leg == "rl":
        strategy = "fedavg"
        sc["wantRL"] = True
        sc["RL"] = {"minibatch_size": 4, "max_replay_memory_size": 16,
                    "optimizer_config": {"type": "adam", "lr": 1e-3}}
    if leg == "personalization":
        strategy = "fedavg"
        sc["type"] = "personalization"
    if leg == "ef_quant":
        cc.update(quant_bits=4, quant_thresh=0.2, quant_anneal=0.9)
    if chaos is not None:
        sc["chaos"] = chaos
    sc.update(server_over)
    return {"model_config": {"model_type": "LR", "num_classes": 4,
                             "input_dim": 8},
            "strategy": strategy, "server_config": sc, "client_config": cc}


def port_dataset():
    jds = make_synthetic_classification()
    return ArraysDataset(jds.user_list,
                         [jds.user_arrays(i) for i in range(len(jds))],
                         jds.num_samples)


def port_server(raw, model_dir, val=False, init_params=None, seed=7):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    ds = port_dataset()
    cls = select_server(cfg.server_config.get("type"))
    return cls(make_task(cfg.model_config), cfg, ds, model_dir=model_dir,
               device="cpu", seed=seed, val_dataset=ds if val else None,
               init_params=init_params)


def port_run(raw, model_dir, **kw):
    server = port_server(raw, model_dir, **kw)
    server.train()
    return server


def assert_same_state(a, b, what):
    assert torch.equal(a.params, b.params), what
    assert sorted(a.strategy_state) == sorted(b.strategy_state), what
    for k, v in a.strategy_state.items():
        assert torch.equal(v, b.strategy_state[k]), (what, k)


_depth0 = {}


def depth0(leg, tmp_path_factory):
    if leg not in _depth0:
        _depth0[leg] = port_run(raw_config(leg, depth=0),
                                str(tmp_path_factory.mktemp(leg)))
    return _depth0[leg]


# ----------------------------------------------------------------------
@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("depth", [1, 2])
def test_depths_are_bitwise_and_pipelined(leg, depth, tmp_path,
                                          tmp_path_factory):
    want = depth0(leg, tmp_path_factory)
    server = port_run(raw_config(leg, depth=depth), str(tmp_path))
    assert server._pipeline_ok() and server.pipelined_chunks > 0
    assert server.rl is None and server.scaffold_store is None and \
        server.ef_store is None
    assert want.pipelined_chunks == 0
    assert_same_state(server.state, want.state, f"{leg} depth {depth}")


@pytest.mark.parametrize("leg", ["scaffold", "ef_quant"])
def test_fused_leg_is_bitwise_the_host_leg(leg, tmp_path, tmp_path_factory):
    """The carry math is the host rounds' math on the device: params, and
    SCAFFOLD's controls or EF's residual rows, bitwise those of the host
    store path."""
    fused = depth0(leg, tmp_path_factory)
    host = port_run(raw_config(leg, depth=0, fused=False), str(tmp_path))
    store = host.scaffold_store or host.ef_store
    assert store is not None and not host._pipeline_ok()
    assert torch.equal(fused.state.params, host.state.params)
    ss = fused.state.strategy_state
    ids = store.persisted_client_ids()
    assert len(ids) >= 4
    if leg == "scaffold":
        np.testing.assert_array_equal(ss["c"].numpy(), store.c)
        rows = np.stack([store.ci(i) for i in ids])
    else:
        rows = store.rows(np.asarray(ids))
    table = (ss["ci"] if leg == "scaffold" else ss["res"]).numpy()
    np.testing.assert_array_equal(table[ids], rows)
    rest = np.setdiff1d(np.arange(len(table)), ids)
    assert not table[rest].any()


@pytest.mark.parametrize("leg", LEGS)
def test_carry_leg_with_chaos_depth1_is_depth0(leg, tmp_path):
    """Chaos's dropped clients leave the carry's keep gate, its stragglers'
    truncated masks the SCAFFOLD step count: depth 1 equals depth 0."""
    serial = port_run(raw_config(leg, depth=0, chaos=CHAOS),
                      str(tmp_path / "d0"))
    ring = port_run(raw_config(leg, depth=1, chaos=CHAOS),
                    str(tmp_path / "d1"))
    assert ring.pipelined_chunks > 0
    assert ring.chaos.counters["dropped"] > 0 and \
        ring.chaos.counters["straggled"] > 0
    assert_same_state(ring.state, serial.state, f"{leg} with chaos")


@pytest.mark.parametrize("leg", LEGS)
def test_cut_and_resume_is_bitwise(leg, tmp_path):
    whole = port_run(raw_config(leg), str(tmp_path / "whole"))
    port_run(raw_config(leg, rounds=3), str(tmp_path / "cut"))
    resumed = port_run(raw_config(leg, resume_from_checkpoint=True),
                       str(tmp_path / "cut"))
    assert resumed.state.round == ROUNDS
    assert_same_state(resumed.state, whole.state, f"{leg} resume")


def test_fused_rl_tuner_lives_in_strategy_state(tmp_path):
    server = port_run(raw_config("rl", depth=2), str(tmp_path))
    ss = server.state.strategy_state
    assert server.rl is None and server.engine.fused_rl is not None
    # epsilon annealed, the ring filled, across pipelined rounds
    assert float(ss[PREFIX + "eps"]) < 0.5
    assert int(ss[PREFIX + "count"]) > 0


def test_personalization_carry_marks_users_and_bounds_alpha(tmp_path):
    server = port_run(raw_config("personalization"), str(tmp_path))
    assert server.store is None
    ss = server.state.strategy_state
    seen = ss["seen"].numpy()
    assert set(np.unique(seen)) <= {0.0, 1.0} and seen.sum() >= 4
    alpha = ss["alpha"].numpy()
    assert np.all((alpha >= 1e-4) & (alpha <= 0.9999))
    # an unseen user's row was never written
    assert np.all(ss["local"].numpy()[seen == 0] == 0.0)
    assert np.all(alpha[seen == 0] == np.float32(0.75))


# ---------------------------------------------------------------- JAX
def jax_run(raw, model_dir):
    """The JAX server on ``raw`` with the same data as the val split:
    ``(server, initial params, fused RL's initial state or None, val
    history)``."""
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    ds = make_synthetic_classification()
    cls = jax_select_server(cfg.server_config.get("type"))
    server = cls(jax_make_task(cfg.model_config), cfg, ds, val_dataset=ds,
                 model_dir=model_dir, mesh=make_mesh(num_devices=1), seed=7)
    init = jax.device_get(server.state.params)
    ss = server.state.strategy_state
    rl0 = jax.device_get(ss["rl"]) if isinstance(ss, dict) and "rl" in ss \
        else None
    history, evaluate = [], server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        if split == "val":
            history.append((round_no, server._last_val["loss"].value,
                            server._last_val["acc"].value))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return server, init, rl0, history


def _port_rows(task, jax_like, rows):
    """JAX flat rows (``ravel_pytree`` order of ``jax_like``) in the
    port's layout."""
    _, unravel = ravel_pytree(jax_like)
    layout = task.layout()
    return np.stack([layout.flatten(from_jax_params(
        task, jax.device_get(unravel(jnp.asarray(r))))).numpy()
        for r in np.asarray(rows)])


#: the JAX run's RL tuner: no exploration, a one-slot ring, so the
#: packages' different random streams decide nothing
RL_DETERMINISTIC = {"initial_epsilon": 0.0, "max_replay_memory_size": 1,
                    "minibatch_size": 4,
                    "optimizer_config": {"type": "adam", "lr": 1e-3}}


@pytest.mark.parametrize("leg", LEGS)
def test_leg_matches_the_jax_package(leg, tmp_path):
    raw = raw_config(leg, val_freq=1)
    if leg == "rl":
        raw["server_config"]["RL"] = dict(RL_DETERMINISTIC)
    jserver, init, rl0, want = jax_run(raw, str(tmp_path / "jax"))
    server = port_server(raw, str(tmp_path / "port"), val=True,
                         init_params=from_jax_params(
                             make_task(FLUTEConfig.from_dict(
                                 copy.deepcopy(raw)).model_config), init))
    if rl0 is not None:
        server.state.strategy_state.update(
            fused_rl_from_jax(server.engine.fused_rl, rl0))
    server.train()
    got = [(h["round"], h["loss"], h["acc"]) for h in server.history
           if h["split"] == "val"]
    n_val = sum(port_dataset().num_samples)
    assert [r for r, _, _ in got] == [r for r, _, _ in want] == \
        list(range(ROUNDS + 1))
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= LOSS_REL * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    task = server.task
    jparams = jax.device_get(jserver.state.params)
    np.testing.assert_allclose(
        server.state.params.numpy(),
        task.layout().flatten(from_jax_params(task, jparams)).numpy(),
        rtol=1e-5, atol=1e-7)
    jss = jax.device_get(jserver.state.strategy_state)
    ss = server.state.strategy_state
    if leg == "scaffold":
        np.testing.assert_allclose(
            ss["c"].numpy(), _port_rows(task, jparams, [jss["c"]])[0],
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            ss["ci"].numpy(), _port_rows(task, jparams, jss["ci"]),
            rtol=1e-5, atol=1e-6)
    if leg == "ef_quant":
        # a residual entry that lands a level apart under the packages'
        # last-bit differences differs by a level: compare the rows'
        # norms and the entries that agree in level
        got_res = ss["res"].numpy()
        want_res = _port_rows(task, jparams, jss["res"])
        np.testing.assert_allclose(np.linalg.norm(got_res, axis=1),
                                   np.linalg.norm(want_res, axis=1),
                                   rtol=1e-4, atol=1e-7)
        assert np.mean(np.isclose(got_res, want_res, rtol=1e-5,
                                  atol=1e-7)) > 0.99
    if leg == "personalization":
        np.testing.assert_array_equal(ss["seen"].numpy(), jss["seen"])
        np.testing.assert_allclose(ss["alpha"].numpy(), jss["alpha"],
                                   rtol=1e-5)
        np.testing.assert_allclose(
            ss["local"].numpy(), _port_rows(task, jparams, jss["local"]),
            rtol=1e-5, atol=1e-6)
        ds = port_dataset()
        res = server.personalized_eval(ds)
        assert res is not None and server.personalized_eval(ds) == res
        jres = jserver.personalized_eval(make_synthetic_classification())
        assert abs(res[0] - jres[0]) * n_val <= 1.0 + 1e-9, (res, jres)
        assert abs(res[1] - jres[1]) <= LOSS_REL * abs(jres[1]), (res, jres)
    if leg == "rl":
        for key in ("count", "ptr", "eps"):
            np.testing.assert_allclose(ss[PREFIX + key].numpy(),
                                       jss["rl"][key], rtol=1e-6)


def test_personalized_eval_is_none_before_any_user_is_seen(tmp_path):
    server = port_server(raw_config("personalization"), str(tmp_path),
                         val=True)
    assert server.personalized_eval(port_dataset()) is None


# ---------------------------------------------------------- EF's step
@pytest.mark.parametrize("bits,thresh", [(4, 0.0), (4, 0.3), (2, 0.6)])
def test_ef_carry_step_is_bitwise_the_jax_plain_path(bits, thresh):
    raw = raw_config("ef_quant")
    raw["client_config"].update(quant_bits=bits, quant_thresh=thresh)
    jstrat = jax_select_strategy("ef_quant")(
        JaxFLUTEConfig.from_dict(copy.deepcopy(raw)), None)
    pstrat = select_strategy("ef_quant")(
        FLUTEConfig.from_dict(copy.deepcopy(raw)))
    pstrat.carry_clients = 7
    assert pstrat.device_carry and not pstrat.host_rounds
    rng = np.random.default_rng(bits)
    K, P = 5, 1003
    pgs = (rng.normal(size=(K, P)) *
           np.logspace(-3, 0, K)[:, None]).astype(np.float32)
    table = (0.01 * rng.normal(size=(7, P))).astype(np.float32)
    ids = np.asarray([4, 0, -1, 6, 2], np.int64)
    live = np.asarray([1, 1, 1, 0, 1], np.float32)
    w = np.asarray([3, 5, 0, 2, 0], np.float32)   # client 2: weight 0

    def client_update(g, arrays, mask, lr, gens, grad_offset=None):
        return (torch.from_numpy(pgs), torch.zeros(K), torch.from_numpy(w),
                {k: torch.zeros(K) for k in ("mean", "mag",
                                              "var_corrected", "norm")})

    parts, _, _, _, carry = pstrat.client_step_carry(
        client_update, torch.zeros(P), {}, torch.ones(K, 1, 1), 0.1, None,
        client_ids=torch.from_numpy(ids), live_mask=torch.from_numpy(live),
        strategy_state={"res": torch.from_numpy(table)},
        quant_threshold=thresh)
    res_rows = table[np.clip(ids, 0, None)] * (ids >= 0)[:, None]
    jq, jres = jstrat.ef_step(jnp.asarray(pgs), jnp.asarray(res_rows))
    np.testing.assert_array_equal(parts["default"][0].numpy(),
                                  np.asarray(jq))
    keep = (ids >= 0) & (live > 0) & (w > 0)
    np.testing.assert_array_equal(carry["keep"].numpy(), keep)
    np.testing.assert_array_equal(
        carry["row"].numpy(), np.where(keep[:, None], np.asarray(jres),
                                       res_rows))
    src = np.asarray([0, 1, 0, 3, 4], np.int64)   # the padding slot -> 0
    new = pstrat.apply_carry({"res": torch.from_numpy(table)},
                             torch.from_numpy(ids), torch.from_numpy(src),
                             carry)["res"]
    jnew = jstrat.apply_carry({"res": jnp.asarray(table)},
                              jnp.asarray(ids, jnp.int32),
                              {"row": jnp.asarray(carry["row"].numpy()),
                               "keep": jnp.asarray(keep, jnp.float32)})
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew["res"]))
    # the rows of the padded, dropped and zero-weight slots are untouched
    for cid in (6, 2, 1, 3, 5):
        np.testing.assert_array_equal(new[cid].numpy(), table[cid])


# ------------------------------------------------------------ fused RL
def _rl_pair(k=4, **over):
    raw = {"initial_epsilon": 0.5, "minibatch_size": 3,
           "max_replay_memory_size": 5, "network_params": [4 * k, 16, 8, k],
           "optimizer_config": {"type": "adam", "lr": 1e-2}, **over}
    jrl = JaxFusedRL(JaxRLConfig.from_dict(copy.deepcopy(raw)), k)
    prl = FusedRL(RLConfig.from_dict(copy.deepcopy(raw)), k)
    return jrl, prl


def test_fused_rl_weights_carry_across(tmp_path):
    """A JAX ``FusedRL.init_state`` through the converter: the port's net
    gives the flax net's forward."""
    jrl, prl = _rl_pair()
    jstate = jax.device_get(jrl.init_state(jax.random.PRNGKey(3)))
    pstate = fused_rl_from_jax(prl, jstate)
    x = np.random.default_rng(0).normal(size=(6, prl.in_dim)).astype(
        np.float32)
    want = np.asarray(jrl.net.apply({"params": jstate["net"]},
                                    jnp.asarray(x)))
    got = prl.apply(pstate[PREFIX + "net"], torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert float(pstate[PREFIX + "eps"]) == 0.5
    assert int(pstate[PREFIX + "count"]) == 0
    assert pstate[PREFIX + "opt.mu"].shape == pstate[PREFIX + "net"].shape


def test_fused_rl_combine_matches_jax():
    """Four rounds of the tuner from one carried-across state, the JAX
    draws handed in: aggregate, ``eps``, ``count``, ``ptr`` and the net
    ``rtol 1e-5``; a round explored and one not."""
    k, P = 4, 50
    jrl, prl = _rl_pair(k)
    jstate = jrl.init_state(jax.random.PRNGKey(3))
    pstate = fused_rl_from_jax(prl, jax.device_get(jstate))
    rng = np.random.default_rng(1)
    explored = set()
    for r in range(4):
        pc = {"w": rng.uniform(0.0, 3.0, k).astype(np.float32),
              "mag": rng.uniform(size=k).astype(np.float32),
              "mean": rng.normal(size=k).astype(np.float32),
              "var": rng.uniform(size=k).astype(np.float32)}
        pc["w"][2] = 0.0
        stack = rng.normal(size=(k, P)).astype(np.float32)
        loss = np.float32(1.0 - 0.1 * r + (0.3 if r == 2 else 0.0))
        key = jax.random.PRNGKey(10 + r)
        jagg, jstate_new, jstats = jrl.combine(
            jstate, {f: jnp.asarray(v) for f, v in pc.items()},
            jnp.asarray(stack), jnp.asarray(loss), key)
        count = int(jstate_new["count"])
        draws = {
            "coin": torch.tensor(float(jax.random.uniform(
                jax.random.fold_in(key, 2)))),
            "rand_action": torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.fold_in(key, 3), (k,)))),
            "idx": torch.from_numpy(np.asarray(jax.random.randint(
                jax.random.fold_in(key, 1), (prl.minibatch,), 0,
                max(count, 1)))).long()}
        pagg, pstate, pstats = prl.combine(
            pstate, {f: torch.from_numpy(v) for f, v in pc.items()},
            torch.from_numpy(stack), torch.tensor(loss), draws=draws)
        np.testing.assert_allclose(pagg.numpy(), np.asarray(jagg),
                                   rtol=1e-5, atol=1e-6)
        for name in ("count", "ptr", "eps", "prev_a", "replay_r"):
            np.testing.assert_allclose(pstate[PREFIX + name].numpy(),
                                       np.asarray(jstate_new[name]),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            pstate[PREFIX + "net"].numpy(),
            fused_rl_from_jax(prl, jax.device_get(jstate_new))[
                PREFIX + "net"].numpy(), rtol=1e-5, atol=1e-6)
        for name in ("rl_reward", "rl_qloss", "rl_explored"):
            np.testing.assert_allclose(float(pstats[name]),
                                       float(jstats[name]), rtol=1e-5,
                                       atol=1e-6)
        explored.add(bool(jstats["rl_explored"]))
        jstate = jstate_new
    assert explored == {True, False}


# ------------------------------------------------------------ refusals
def _dataset(seed=0):
    rng = np.random.default_rng(seed)
    users = [f"u{i}" for i in range(4)]
    arrays = [{"x": rng.normal(size=(6, 8)).astype(np.float32),
               "y": rng.integers(0, 4, 6).astype(np.int32)}
              for _ in range(4)]
    return users, arrays


def _edit(raw, *edits):
    raw = copy.deepcopy(raw)
    for path, value in edits:
        node = raw
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return raw


def _outcome(build):
    """None when ``build()`` returns, else the exception's type."""
    try:
        build()
    except Exception as exc:   # the type is what is compared
        return type(exc)
    return None


def jax_build(raw, tmp_path):
    from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cls = jax_select_server(cfg.server_config.get("type"))
    return cls(jax_make_task(cfg.model_config), cfg,
               JaxArraysDataset(*_dataset()),
               val_dataset=JaxArraysDataset(*_dataset(1)),
               model_dir=str(tmp_path / "jax"),
               mesh=make_mesh(num_devices=1), seed=0)


def port_build(raw, tmp_path):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cls = select_server(cfg.server_config.get("type"))
    return cls(make_task(cfg.model_config), cfg, ArraysDataset(*_dataset()),
               val_dataset=ArraysDataset(*_dataset(1)),
               model_dir=str(tmp_path / "port"), device="cpu", seed=0)


LOCAL_DP = {"enable_local_dp": True, "eps": -1.0, "max_grad": 1.0,
            "max_weight": 10.0, "min_weight": 0.0, "weight_scaler": 1.0}
ADAPTIVE = {**LOCAL_DP, "adaptive_clipping": {"target_quantile": 0.5}}
#: (config, whether the JAX package refuses it)
FUSED_CONFIGS = {
    "scaffold": (raw_config("scaffold"), False),
    "ef_quant": (raw_config("ef_quant"), False),
    "rl": (raw_config("rl"), False),
    "personalization": (raw_config("personalization"), False),
    "personalization_fedprox": (_edit(raw_config("personalization"),
                                      ("strategy", "fedprox")), False),
    "fedavg": (_edit(raw_config("scaffold"), ("strategy", "fedavg")),
               False),
    "scaffold_chunked": (_edit(raw_config("scaffold"), (
        "server_config.clients_per_chunk", 2)), True),
    "ef_quant_chunked": (_edit(raw_config("ef_quant"), (
        "server_config.clients_per_chunk", 2)), True),
    "personalization_chunked": (_edit(raw_config("personalization"), (
        "server_config.clients_per_chunk", 2)), True),
    "rl_chunked": (_edit(raw_config("rl"), (
        "server_config.clients_per_chunk", 2)), True),
    "rl_on_scaffold": (_edit(raw_config("scaffold"), (
        "server_config.wantRL", True)), True),
    "rl_on_ef_quant": (_edit(raw_config("ef_quant"), (
        "server_config.wantRL", True)), True),
    "rl_on_personalization": (_edit(raw_config("personalization"), (
        "server_config.wantRL", True)), True),
    "rl_on_dga": (_edit(raw_config("rl"), ("strategy", "dga")), True),
    "rl_on_dga_stale": (_edit(raw_config("rl"), ("strategy", "dga"), (
        "server_config.stale_prob", 0.3)), True),
    "rl_adaptive_clipping": (_edit(raw_config("rl"), (
        "dp_config", ADAPTIVE)), True),
    "rl_on_secure_agg": (_edit(raw_config("rl"), ("strategy",
                                                  "secure_agg")), True),
    "rl_on_fedlabels": (_edit(raw_config("rl"), ("strategy",
                                                 "fedlabels")), True),
    "rl_lstm": (_edit(raw_config("rl"), ("server_config.RL.wantLSTM",
                                         True)), True),
    "rl_cohort_range": (_edit(raw_config("rl"), (
        "server_config.num_clients_per_iteration", "2:4")), True),
    "ef_quant_adaptive_clipping": (_edit(raw_config("ef_quant"), (
        "dp_config", ADAPTIVE)), True),
    "personalization_local_dp": (_edit(raw_config("personalization"), (
        "dp_config", LOCAL_DP)), True),
    "personalization_init_random": (_edit(raw_config("personalization"), (
        "server_config.personalization_init", "random")), True),
    "personalization_qffl": (_edit(raw_config("personalization"), (
        "strategy", "qffl")), True),
    "personalization_chaos": (_edit(raw_config("personalization"), (
        "server_config.chaos", {**CHAOS, "dropout_rate": 0.3})), False),
    "personalization_robust": (_edit(raw_config("personalization"), (
        "server_config.robust", {"aggregator": "mean"})), True),
    "ef_quant_chaos": (_edit(raw_config("ef_quant"), (
        "server_config.chaos", CHAOS)), False),
    "rl_chaos": (_edit(raw_config("rl"), ("server_config.chaos", CHAOS)),
                 False),
    "rl_screened_mean": (_edit(raw_config("rl"), (
        "server_config.robust", {"aggregator": "mean"})), False),
    "rl_median": (_edit(raw_config("rl"), (
        "server_config.robust", {"aggregator": "median"})), True),
}


@pytest.mark.parametrize("name", sorted(FUSED_CONFIGS))
def test_fused_carry_accepts_and_refuses_as_the_jax_package(name,
                                                            tmp_path):
    raw, refused = FUSED_CONFIGS[name]
    want = _outcome(lambda: jax_build(raw, tmp_path))
    got = _outcome(lambda: port_build(raw, tmp_path))
    assert want == (ValueError if refused else None), want
    assert got == want, (got, want)
