"""The device-resident sample pool in the port
(``data_config.train.device_resident``: ``data/batching.py::
build_sample_pool`` / ``pack_round_indices``, ``engine/round.py::
attach_pool`` and the gather, ``engine/server.py``) against the JAX
package's (``data/batching.py:191-296``, ``engine/round.py:743-757,
826-840, 1910-1944``, ``engine/server.py:604-626, 1321-1330, 2175-2193``):

- the pool and the index grids equal the JAX functions', and the index
  packer draws what the port's row packer draws;
- the gather zeroes padding slots to +0.0, as host packing writes them,
  on a pool whose row 0 holds -0.5 and NaN;
- pool-mode training bitwise equal to host packing in the port:
  monolithic, ``rounds_per_step: 3`` on the ring, ``clients_per_chunk``,
  cohort bucketing, megabatching, chaos faults and corruption, the
  personalization server and server replay;
- ``hostToDeviceBytesPerRound`` and the params against the JAX server's,
  host-packed and pooled (LR, and a CNN_FEMNIST trajectory in pool mode);
- the refusals: host-orchestrated rounds (``ValueError`` in both
  packages), a batch of the wrong kind ("pool mode mismatch"), and the
  combination the JAX package fails on (pool, cohort bucketing and a
  sequence task: ``AttributeError`` there), where the port skips the crop.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
from msrflute_tpu.data import batching as jb
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data import batching as pb
from msrflute_tpu_torch.data.dataset import ArraysDataset
from msrflute_tpu_torch.engine.server import select_server
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from test_torch_cohort_bucketing import (BUCKETS, jax_server, port_hetero,
                                         port_server, raw_cfg)
from test_torch_length_bucketing import (jax_lstm_server, lstm_raw,
                                         port_lstm_server)
from test_torch_trainer import (_port_history, _port_server, _raw_config,
                                _run_jax, _write_blob)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread while this file runs: the LSTM's step loop is
    thousands of tiny ops, whose thread pools spin against the other test
    workers' on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def resident(raw, on=True):
    raw = copy.deepcopy(raw)
    raw["client_config"]["data_config"]["train"]["device_resident"] = on
    return raw


def mixed_users(seed=0):
    """Users with float features (negatives among them), uint8 pixels and
    int labels."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 1, 9, 3, 12, 7):
        out.append({"x": rng.normal(size=(n, 3)).astype(np.float32),
                    "img": rng.integers(0, 256, (n, 4, 4, 1), np.uint8),
                    "y": rng.integers(0, 4, n).astype(np.int32)})
    return [f"m{i}" for i in range(len(out))], out


def test_pool_and_index_grids_equal_the_jax_functions():
    names, users = mixed_users()
    ds = ArraysDataset(names, copy.deepcopy(users))
    jds = JaxArraysDataset(names, copy.deepcopy(users))
    pool, offsets = pb.build_sample_pool(ds)
    jpool, joffsets = jb.build_sample_pool(jds)
    np.testing.assert_array_equal(offsets, joffsets)
    assert sorted(pool) == sorted(jpool)
    for k in pool:
        assert pool[k].dtype == jpool[k].dtype == users[0][k].dtype
        assert pool[k].tobytes() == jpool[k].tobytes()
    orders = {c: np.random.default_rng(c).permutation(len(users[c]["y"]))
              for c in (2, 4)}
    cases = [dict(ids=[2, 5, 0], S=3, pad_clients_to=5,
                  desired_max_samples=7),
             dict(ids=[4, -1, 2], S=4, orders=orders),
             dict(ids=[1, 3], S=2, shuffle=False), dict(ids=[-1], S=1)]
    for case in cases:
        case = dict(case)
        ids, S = case.pop("ids"), case.pop("S")
        rngs = [np.random.default_rng(9) for _ in range(3)]
        mine = pb.pack_round_indices(ds, offsets, ids, 4, S, rng=rngs[0],
                                     **case)
        ref = jb.pack_round_indices(jds, joffsets, ids, 4, S, rng=rngs[1],
                                    **case)
        rows = pb.pack_round_batches(ds, ids, 4, S, rng=rngs[2], **case)
        for key in ("indices", "sample_mask", "num_samples", "client_mask",
                    "client_ids"):
            np.testing.assert_array_equal(getattr(mine, key),
                                          getattr(ref, key))
        assert mine.indices.dtype == np.int32
        # draw for draw the row packer's, and the rows it packs
        assert rngs[0].bit_generator.state == rngs[1].bit_generator.state \
            == rngs[2].bit_generator.state
        live = rows.sample_mask > 0
        for k in pool:
            np.testing.assert_array_equal(pool[k][mine.indices][live],
                                          rows.arrays[k][live])


def test_gather_zeroes_padding_as_host_packing_does(tmp_path):
    names, users = mixed_users()
    users[0]["x"][0] = [-0.5, np.nan, -2.0]
    ds = ArraysDataset(names, users)
    pool, offsets = pb.build_sample_pool(ds)
    server = port_server(raw_cfg(rounds=1), tmp_path)
    engine = server.engine
    engine.attach_pool(pool)
    assert engine.pool_bytes == sum(v.nbytes for v in pool.values())
    rng = np.random.default_rng(1)
    batch = pb.pack_round_indices(ds, offsets, [1, 3, -1], 4, 3, rng=rng,
                                  pad_clients_to=4)
    rows = pb.pack_round_batches(ds, [1, 3, -1], 4, 3,
                                 rng=np.random.default_rng(1),
                                 pad_clients_to=4)
    got = engine._gather_pool(torch.from_numpy(batch.indices),
                              torch.from_numpy(batch.sample_mask))
    for k, v in rows.arrays.items():
        assert got[k].dtype == torch.from_numpy(v).dtype
        assert got[k].numpy().tobytes() == v.tobytes(), k


POOL_CASES = {
    "monolithic": dict(),
    "rounds_per_step": dict(rounds_per_step=3, pipeline_depth=1),
    "clients_per_chunk": dict(clients_per_chunk=4),
    "bucketed": dict(cohort_bucketing=BUCKETS),
    "megabatch": dict(cohort_bucketing=BUCKETS,
                      megabatch={"enable": True, "min_gain": 0.0}),
    "chaos": dict(chaos={"seed": 5, "dropout_rate": 0.2,
                         "straggler_rate": 0.3, "corrupt_scale_rate": 0.2}),
    "personalization": dict(strategy="personalization"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_training_is_bitwise_host_packing(case, tmp_path):
    raw = raw_cfg(rounds=4, **POOL_CASES[case])
    host = port_server(raw, tmp_path / "host")
    pooled = port_server(resident(raw), tmp_path / "pool")
    assert host.engine.pool_mode is False and pooled.engine.pool_mode
    host.train()
    pooled.train()
    assert torch.equal(host.state.params, pooled.state.params)
    assert host.padding_efficiency == pooled.padding_efficiency
    hb = host.run_stats["hostToDeviceBytesPerRound"]
    pbytes = pooled.run_stats["hostToDeviceBytesPerRound"]
    assert len(hb) == len(pbytes) > 0
    # LR's 8 f32 features and an int32 label a slot against one index
    assert all(h == 5 * p for h, p in zip(hb, pbytes))
    if case == "megabatch":
        assert "mega" in pooled.engine.mega_gate.values()
    if case == "chaos":
        assert pooled.chaos.counters == host.chaos.counters


def test_server_replay_in_pool_mode(tmp_path):
    """Server replay trains on the server's own rows, packed on the host
    in either mode (``server.py:2366-2411``): the run is bitwise the
    host-packed one."""
    raw = raw_cfg(rounds=2, server_replay_config={
        "server_iterations": 1,
        "optimizer_config": {"type": "sgd", "lr": 0.1}})
    runs = []
    for name, r in (("host", raw), ("pool", resident(raw))):
        cfg = FLUTEConfig.from_dict(copy.deepcopy(r))
        server = select_server(None)(
            make_task(cfg.model_config), cfg, port_hetero(),
            model_dir=str(tmp_path / name), device="cpu", seed=7,
            server_train_dataset=port_hetero([6, 9]))
        assert server.server_replay is not None
        server.train()
        runs.append(server.state.params)
    assert torch.equal(*runs)


@pytest.mark.parametrize("mode", ["host", "pool", "pool_bucketed"])
def test_bytes_and_params_equal_the_jax_servers(mode, tmp_path):
    raw = raw_cfg(rounds=3, rounds_per_step=2,
                  cohort_bucketing=BUCKETS if mode == "pool_bucketed"
                  else None)
    if mode != "host":
        raw = resident(raw)
    jserver = jax_server(raw, tmp_path / "j")
    assert (jserver.engine._pool is not None) == (mode != "host")
    server = port_server(raw, tmp_path / "p")
    init = jax.device_get(jserver.state.params)
    server.state = server.engine.init_state(from_jax_params(server.task,
                                                            init))
    jserver.train()
    server.train()
    assert server.run_stats["hostToDeviceBytesPerRound"] == \
        jserver.run_stats["hostToDeviceBytesPerRound"]
    want = server.task.layout().flatten(from_jax_params(
        server.task, jax.device_get(jserver.state.params)))
    torch.testing.assert_close(server.state.params, want, rtol=1e-5,
                               atol=1e-7)


@pytest.fixture(scope="module")
def cnn_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool_cnn")
    _write_blob(d / "train.json", 4, "cnn", 5, 10, seed=0)
    _write_blob(d / "val.json", 3, "cnn", 5, 10, seed=1)
    return str(d)


def test_cnn_pool_trajectory_matches_the_jax_pool(cnn_blob, tmp_path):
    """CNN_FEMNIST without dropout, 3 rounds, both packages in pool mode:
    val loss to ``test_torch_trainer``'s ``rel 1e-4``."""
    from msrflute_tpu.parallel import make_mesh
    raw = resident(_raw_config("cnn", 3))
    init, want, _ = _run_jax(raw, cnn_blob, str(tmp_path / "jax"),
                             make_mesh(num_devices=1))
    server = _port_server(raw, cnn_blob, str(tmp_path / "port"), init)
    assert server.engine.pool_mode
    got = _port_history(server)
    assert len(got) == len(want) == 4
    for (r, gl, _), (_, wl, _) in zip(got, want):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (r, gl, wl)


@pytest.mark.parametrize("strategy", ["rl", "scaffold", "ef_quant"])
def test_host_rounds_refuse_the_pool_as_the_jax_server_does(strategy,
                                                             tmp_path):
    """The config refuses the flag beside a host-orchestrated round; past
    it (the flag set on the parsed config, as the JAX package's parser
    lets it through) both servers raise ``ValueError`` at construction."""
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu.engine import OptimizationServer as JaxServer
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.parallel import make_mesh
    from test_torch_cohort_bucketing import jax_hetero
    raw = (raw_cfg(strategy="dga", wantRL=True) if strategy == "rl"
           else raw_cfg(strategy=strategy))
    with pytest.raises(ValueError, match="host-orchestrated"):
        FLUTEConfig.from_dict(resident(raw))
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.client_config.data_config.train["device_resident"] = True
    with pytest.raises(ValueError, match="host-orchestrated") as err:
        select_server(None)(make_task(cfg.model_config), cfg, port_hetero(),
                            model_dir=str(tmp_path / "p"), device="cpu")
    jcfg = JaxFLUTEConfig.from_dict(resident(raw))
    with pytest.raises(ValueError) as jerr:
        JaxServer(jax_make_task(jcfg.model_config), jcfg, jax_hetero(),
                  model_dir=str(tmp_path / "j"),
                  mesh=make_mesh(num_devices=1))
    assert str(err.value) == str(jerr.value)


def test_a_batch_of_the_other_kind_raises_the_mismatch(tmp_path):
    ds = port_hetero()
    for on in (True, False):
        server = port_server(resident(raw_cfg(rounds=1), on),
                             tmp_path / str(on))
        if on:
            batch = pb.pack_round_batches(ds, [0, 1], 4, 3)
        else:
            pool, offsets = pb.build_sample_pool(ds)
            batch = pb.pack_round_indices(ds, offsets, [0, 1], 4, 3)
        kind = "arrays" if on else "indices"
        with pytest.raises(ValueError,
                           match=f"pool mode mismatch: batch={kind}"):
            server.engine.run_round(server.state, batch, 0.1, 1.0)


def test_bucketed_pool_skips_the_crop_where_the_jax_server_fails(tmp_path):
    """Pool mode, cohort bucketing and a sequence task: the JAX server's
    bucketed pack hands ``IndexRoundBatch``es to its length crop, which
    reads ``arrays`` and raises ``AttributeError`` (``server.py:
    1308-1316``); its monolithic pool path skips the crop (``:1321-1330``).
    The port skips it on both layouts: the run is bitwise the host-packed
    bucketed run without length bucketing."""
    buckets = {"enable": True, "max_buckets": 2}
    raw = resident(lstm_raw(rounds=1, bucketing=buckets))
    with pytest.raises(AttributeError, match="arrays"):
        jax_lstm_server(raw, tmp_path / "j").train()
    pooled = port_lstm_server(raw, tmp_path / "pool")
    pooled.train()
    assert pooled._length_bucket_stats is None
    host = port_lstm_server(lstm_raw(rounds=1, bucketing=buckets,
                                     length_bucketing=False),
                            tmp_path / "host")
    host.train()
    assert torch.equal(pooled.state.params, host.state.params)
    mono = port_lstm_server(resident(lstm_raw(rounds=1)), tmp_path / "mono")
    mono.train()
    assert mono._length_bucket_stats is None
