"""Length bucketing in the port (``data_config.train.length_bucketing``, on
by default): ``data/batching.py::seq_length_bucket`` and
``engine/server.py::_maybe_length_bucket`` against the JAX package's
(``data/batching.py:685-744``, ``engine/server.py:2195-2210``):

- the crop and its stats dict equal the JAX function's on the same grids
  (a longest sentence that ends exactly at the bucket, explicit ``y``, a
  ``tok_mask`` that marks unk ids 0, a chunk of several grids, no crop);
- a client update on the cropped grid within the JAX package's ``1e-6``
  of the uncropped one, for the LSTM and the reference GRU (whose targets
  are the full ``x``, so the last real token's target must survive);
- the server's chunk stats, ``hostToDeviceBytesPerRound`` and params
  against the JAX server's, monolithic and bucketed, one bucket over every
  round and grid of a chunk, and the crop of a host round (SCAFFOLD);
- the key's default and type.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
from msrflute_tpu.data import batching as jb
from msrflute_tpu_torch.config import (FLUTEConfig, ModelConfig,
                                      OptimizerConfig, SchemaError)
from msrflute_tpu_torch.data import batching as pb
from msrflute_tpu_torch.data.dataset import ArraysDataset
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.engine.server import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params

LSTM = {"model_type": "LSTM", "vocab_size": 30, "seq_len": 16}
GRU = {"model_type": "GRU", "vocab_size": 30, "embed_dim": 8,
       "hidden_dim": 16, "max_num_words": 30}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread while this file runs: the LSTM's step loop is
    thousands of tiny ops, whose thread pools spin against the other test
    workers' on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def varlen_users(users=6, rows=8, L=64, real_max=11, vocab=50, seed=0,
                 keys=("x",)):
    """Users of 0-padded ``[rows, L]`` token rows of 3..``real_max`` ids;
    ``tok_mask`` (when asked) marks every real position, an unk id 0 among
    them; ``y`` is ``x`` shifted left."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(users):
        x = np.zeros((rows, L), np.int32)
        tok = np.zeros((rows, L), np.float32)
        for r in range(rows):
            n = int(rng.integers(3, real_max + 1))
            x[r, :n] = rng.integers(1, vocab, size=n)
            tok[r, :n] = 1.0
            if n > 3 and rng.random() < 0.3:
                x[r, n - 1] = 0            # a real unk word at the end
        user = {"x": x}
        if "tok_mask" in keys:
            user["tok_mask"] = tok
        if "y" in keys:
            user["y"] = np.concatenate([x[:, 1:], np.zeros((rows, 1),
                                                           np.int32)], 1)
        out.append(user)
    return [f"u{i}" for i in range(users)], out


def both_datasets(**kw):
    names, users = varlen_users(**kw)
    return (ArraysDataset(names, copy.deepcopy(users)),
            JaxArraysDataset(names, copy.deepcopy(users)))


CROP_CASES = {
    "x_only": dict(keys=("x",)),
    "ends_at_bucket": dict(L=32, real_max=16, keys=("x", "tok_mask")),
    "y_and_tok_mask": dict(keys=("x", "y", "tok_mask")),
    "no_crop": dict(L=16, real_max=16, keys=("x",)),
    "min_len": dict(L=64, real_max=4, keys=("x", "tok_mask")),
}


@pytest.mark.parametrize("case", sorted(CROP_CASES))
def test_crop_and_stats_equal_the_jax_function(case):
    ds, jds = both_datasets(**CROP_CASES[case])
    ids = [[0, 1, 2], [3, 4], [5, 0]]
    mine = [pb.pack_round_batches(ds, c, 4, 2, rng=np.random.default_rng(i))
            for i, c in enumerate(ids)]
    ref = [jb.pack_round_batches(jds, c, 4, 2, rng=np.random.default_rng(i))
           for i, c in enumerate(ids)]
    keys = ("x", "y", "tok_mask")
    stats = pb.seq_length_bucket(mine, keys)
    assert stats == jb.seq_length_bucket(ref, keys)
    for a, b in zip(mine, ref):
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            np.testing.assert_array_equal(a.arrays[k], b.arrays[k])
    assert len({b.arrays["x"].shape[-1] for b in mine}) == 1
    assert mine[0].arrays["x"].shape[-1] == stats["bucket"]
    assert pb.seq_length_bucket(mine, ("not_there",)) is None


@pytest.mark.parametrize("model", ["lstm", "gru"])
def test_client_update_after_the_crop_is_within_1e6(model):
    """The JAX package's bar (``tests/test_length_bucketing.py:60-96``):
    the pseudo-gradient on the cropped grid within ``1e-6`` of the full
    one, the loss too, the sample count equal.  The GRU reads ``x[:, :-1]``
    and targets the full ``x``; its longest sentence ends exactly at the
    bucket (16 of 32); the LSTM's rows crop from 16 to 8."""
    cfg = LSTM if model == "lstm" else GRU
    keys = ("x",) if model == "lstm" else ("x", "tok_mask")
    L, real_max, bucket = (16, 7, 8) if model == "lstm" else (32, 16, 16)
    ds, _ = both_datasets(users=2, rows=6, L=L, vocab=30, keys=keys,
                          real_max=real_max)
    task = make_task(ModelConfig.from_dict(dict(cfg)))
    flat = task.layout().flatten(task.init_params(0))
    update = build_client_update(
        task, OptimizerConfig(type="sgd", lr=0.5), ClientHParams())
    out = {}
    for tag in ("full", "crop"):
        batch = pb.pack_round_batches(ds, [0, 1], 3, 2,
                                      rng=np.random.default_rng(0))
        if tag == "crop":
            stats = pb.seq_length_bucket([batch], task.seq_pad_keys)
            assert stats["bucket"] == bucket and stats["cropped"]
        arrays = {k: torch.from_numpy(v) for k, v in batch.arrays.items()}
        pg, tl, ns, _ = update(flat, arrays,
                               torch.from_numpy(batch.sample_mask), 0.5,
                               None)
        out[tag] = (pg, tl, ns)
    torch.testing.assert_close(out["crop"][0], out["full"][0], rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(out["crop"][1], out["full"][1], rtol=0,
                               atol=1e-6)
    assert torch.equal(out["crop"][2], out["full"][2])
    assert float(out["full"][0].abs().max()) > 0


def lstm_raw(rounds=2, bucketing=None, length_bucketing=True, **server):
    sc = {"max_iteration": rounds, "num_clients_per_iteration": 4,
          "initial_lr_client": 0.5, "val_freq": 100, "initial_val": False,
          "pipeline_depth": 0,
          "optimizer_config": {"type": "sgd", "lr": 1.0},
          "data_config": {"val": {"batch_size": 8}}, **server}
    if bucketing is not None:
        sc["cohort_bucketing"] = bucketing
    return {"model_config": dict(LSTM), "strategy": "fedavg",
            "server_config": sc,
            "client_config": {
                "optimizer_config": {"type": "sgd", "lr": 0.5},
                "data_config": {"train": {
                    "batch_size": 4, "length_bucketing": length_bucketing}}}}


def lstm_sizes():
    """8 users of 1-8 rows: 1 or 2 steps at batch 4 (two step buckets)."""
    return [1, 2, 2, 3, 3, 4, 6, 8]


def lstm_datasets():
    names, users = varlen_users(users=8, rows=8, L=16, real_max=7,
                                vocab=30)
    users = [{"x": u["x"][:n]} for u, n in zip(users, lstm_sizes())]
    return (ArraysDataset(names, copy.deepcopy(users)),
            JaxArraysDataset(names, copy.deepcopy(users)))


def port_lstm_server(raw, model_dir, init=None, **kw):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    task = make_task(cfg.model_config)
    return OptimizationServer(task, cfg, lstm_datasets()[0],
                              model_dir=str(model_dir), device="cpu",
                              seed=3, init_params=init, **kw)


def jax_lstm_server(raw, model_dir):
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu.engine import OptimizationServer as JaxServer
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.parallel import make_mesh
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    return JaxServer(jax_make_task(cfg.model_config), cfg,
                     lstm_datasets()[1], model_dir=str(model_dir), seed=3,
                     mesh=make_mesh(num_devices=1))


@pytest.mark.parametrize("layout", ["monolithic", "bucketed"])
def test_server_crop_matches_the_jax_server(layout, tmp_path):
    bucketing = ({"enable": True, "max_buckets": 2}
                 if layout == "bucketed" else None)
    raw = lstm_raw(bucketing=bucketing)
    jserver = jax_lstm_server(raw, tmp_path / "j")
    init = from_jax_params(make_task(ModelConfig.from_dict(LSTM)),
                           jax.device_get(jserver.state.params))
    jserver.train()
    server = port_lstm_server(raw, tmp_path / "p", init)
    server.train()
    assert server._length_bucket_stats == jserver._length_bucket_stats
    assert server._length_bucket_stats["bucket"] == 8
    assert server.run_stats["hostToDeviceBytesPerRound"] == \
        jserver.run_stats["hostToDeviceBytesPerRound"]
    want = server.task.layout().flatten(from_jax_params(
        server.task, jax.device_get(jserver.state.params)))
    torch.testing.assert_close(server.state.params, want, rtol=0, atol=1e-5)
    # off: the full grids, the same run to the JAX e2e test's 1e-5
    off = port_lstm_server(lstm_raw(bucketing=bucketing,
                                    length_bucketing=False),
                           tmp_path / "off", init)
    off.train()
    assert off._length_bucket_stats is None
    torch.testing.assert_close(off.state.params, server.state.params,
                               rtol=0, atol=1e-5)
    assert off.run_stats["hostToDeviceBytesPerRound"][0] > \
        server.run_stats["hostToDeviceBytesPerRound"][0]


def test_one_bucket_covers_every_round_and_grid_of_a_chunk(tmp_path):
    """The crop runs on the packed chunk, before staging: one bucket over
    its R rounds and their bucket grids, a prefetched chunk's too."""
    raw = lstm_raw(rounds=4, bucketing={"enable": True, "max_buckets": 2},
                   rounds_per_step=2)
    server = port_lstm_server(raw, tmp_path)
    chunks = []
    pack = server._pack_chunk

    def recording(R):
        out = pack(R)
        chunks.append((out, dict(server._length_bucket_stats)))
        return out

    server._pack_chunk = recording
    server.train()
    assert len(chunks) == 2
    for rounds, stats in chunks:
        grids = [g for row in rounds for g in row]
        assert len(rounds) == 2 and len(grids) >= 3
        assert {g.arrays["x"].shape[-1] for g in grids} == {stats["bucket"]}


def test_host_round_crops_its_batch(tmp_path):
    """SCAFFOLD's host round crops its packed batch and records its bytes
    (``server.py:2619-2621``)."""
    raw = lstm_raw(rounds=1)
    raw["strategy"] = "scaffold"
    server = port_lstm_server(raw, tmp_path)
    assert server.scaffold_store is not None
    server.train()
    assert server._length_bucket_stats["bucket"] == 8
    (nbytes,) = server.run_stats["hostToDeviceBytesPerRound"]
    # 4 clients x S steps x batch 4, int32 ids at L = 8 and the f32 mask
    assert nbytes / (4 * 4 * (8 * 4 + 4)) in (1, 2)


def test_length_bucketing_defaults_on_and_is_type_checked(tmp_path):
    raw = lstm_raw()
    del raw["client_config"]["data_config"]["train"]["length_bucketing"]
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    server = OptimizationServer(make_task(cfg.model_config), cfg,
                                lstm_datasets()[0], device="cpu",
                                model_dir=str(tmp_path))
    assert server.length_bucketing is True
    from msrflute_tpu.schema import validate as jax_validate
    from msrflute_tpu.schema import SchemaError as JaxSchemaError
    for key in ("length_bucketing", "device_resident"):
        bad = lstm_raw()
        bad["client_config"]["data_config"]["train"][key] = "yes"
        with pytest.raises(SchemaError) as err:
            FLUTEConfig.from_dict(copy.deepcopy(bad))
        with pytest.raises(JaxSchemaError) as jax_err:
            jax_validate(copy.deepcopy(bad))
        assert err.value.errors == [e for e in jax_err.value.errors
                                    if key in e]
