"""RingLM's model options in the port
(``msrflute_tpu_torch/models/ringlm.py``): ``remat``, the local MoE FFN (``moe_experts``) and ``flash_attention:
"auto"``, at the small widths of ``tests/test_torch_ringlm.py``:

- remat on against off, bitwise in the port: K = 3 clients' local steps
  through the client update's ``vmap(grad_and_value)``, flash on and off,
  dense MLP and MoE;
- the port against the JAX package, each from the JAX weights carried
  across: remat, and the MoE FFN with 4 experts, on a 3-round FedAvg
  trajectory of one block, the val loss every round to ``rel 1e-5``
  (``test_torch_ringlm.py``'s tolerance);
- ``_resolve_flash`` decides as the JAX function does at L = 4095 and
  4096 for ``True``, ``False``, ``"auto"``, ``"AUTO"`` and a bad string;
- remat keeps fewer activations under ``vmap(grad)``: one client step's
  peak resident memory, each mode in a fresh process;
- the MoE leaves carry across in the JAX ``ravel_pytree`` order;
- the three options together through the port's CLI on ``-device cpu``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.models.ringlm import _resolve_flash as jax_resolve_flash
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig, OptimizerConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.models.ringlm import FLASH_AUTO_MIN_LEN, _resolve_flash
from msrflute_tpu_torch.tasks import build_task_datasets
from test_torch_ringlm import (CHARS, MC, REPO, _fedavg_config,  # noqa: F401
                               longtext)


def _client_run(mc, K=3, S=2, B=2, L=33, seed=0):
    """``(pseudo_grad [K, P], loss [K])`` of S local SGD steps of K
    clients from one init."""
    task = make_task(dict(mc, model_type="RINGLM"))
    update = build_client_update(task, OptimizerConfig.from_dict(
        {"type": "sgd", "lr": 0.1}), ClientHParams())
    rng = np.random.default_rng(seed)
    x = rng.integers(1, mc["vocab_size"], (K, S, B, L))
    tok = np.ones((K, S, B, L), np.float32)
    tok[0, 1, 1, 20:] = 0.0
    mask = np.ones((K, S, B), np.float32)
    mask[2, 1, 1] = 0.0
    flat = task.layout().flatten(task.init_params(0))
    pg, loss, _, _ = update(flat, {"x": torch.from_numpy(x),
                                   "tok_mask": torch.from_numpy(tok)},
                            torch.from_numpy(mask), 0.1)
    return pg, loss


@pytest.mark.parametrize("moe", [0, 4])
@pytest.mark.parametrize("flash", [False, True])
def test_remat_is_bitwise_the_plain_step(flash, moe):
    """The recompute repeats the forward's operations and the vjp pulls the
    same cotangents through them: remat changes where activations live,
    not one bit of the update."""
    mc = dict(MC, flash_attention=flash, moe_experts=moe)
    pg_plain, loss_plain = _client_run(dict(mc, remat=False))
    pg_remat, loss_remat = _client_run(dict(mc, remat=True))
    assert torch.equal(pg_plain, pg_remat)
    assert torch.equal(loss_plain, loss_remat)
    assert float(pg_plain.abs().max()) > 0


def _trajectories(longtext, tmp_path, rounds, **options):
    """Val loss per round of the JAX server and the port's, both with
    ``options`` and from the JAX server's initial weights."""
    raw = _fedavg_config(rounds)
    # one block: the JAX server's compile dominates the test's time
    raw["model_config"].update(options, num_layers=1)
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(longtext)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    jserver = JaxServer(task, cfg, train, val_dataset=val,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want = []
    evaluate = jserver._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append((round_no, jserver._last_val["loss"].value))
        return improved

    jserver._maybe_eval = recording_eval
    jserver.train()

    pcfg = FLUTEConfig.from_dict(raw)
    pcfg.validate(longtext)
    ptask = make_task(pcfg.model_config)
    ptrain, pval, _ = build_task_datasets(pcfg, ptask)
    server = OptimizationServer(ptask, pcfg, ptrain, val_dataset=pval,
                                model_dir=str(tmp_path / "port"),
                                device="cpu", seed=0,
                                init_params=from_jax_params(ptask, init))
    server.train()
    got = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    return got, want, ptask


@pytest.mark.parametrize("option", ["remat", "moe_experts"])
def test_trajectory_matches_jax(option, longtext, tmp_path):
    options = {"remat": True} if option == "remat" else {"moe_experts": 4}
    got, want, ptask = _trajectories(longtext, tmp_path, 3, **options)
    if option == "moe_experts":
        assert "block_0.moe_ffn.w_out" in ptask.layout().names
    else:
        assert ptask.module.block_0.remat
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    for (r, gl), (_, wl) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
    assert got[-1][1] < got[0][1]        # it learned


@pytest.mark.parametrize("seq_len", [FLASH_AUTO_MIN_LEN - 1,
                                     FLASH_AUTO_MIN_LEN])
@pytest.mark.parametrize("flag", [True, False, "auto", "AUTO", "sometimes"])
def test_resolve_flash_decides_as_the_jax_package(flag, seq_len):
    assert FLASH_AUTO_MIN_LEN == 4096
    if flag == "sometimes":
        with pytest.raises(ValueError, match="bool or 'auto'"):
            jax_resolve_flash(flag, seq_len)
        with pytest.raises(ValueError, match="bool or 'auto'"):
            _resolve_flash(flag, seq_len)
        return
    assert _resolve_flash(flag, seq_len) == jax_resolve_flash(flag, seq_len)


def test_auto_takes_flash_from_the_sequence_the_model_sees():
    """``seq_len`` counts the shifted target, so the model sees
    ``seq_len - 1`` tokens: 4097 takes flash, 4096 the dense arm, as the
    JAX task decides."""
    for seq_len, flash in ((4097, True), (4096, False), (33, False)):
        task = make_task(dict(MC, model_type="RINGLM", num_layers=1,
                              seq_len=seq_len, flash_attention="auto"))
        assert task.module.block_0._MHA_0.use_flash is flash


def test_cli_runs_the_three_options_on_cpu(longtext, tmp_path):
    with open(os.path.join(REPO, "experiments", "ringlm",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"].update(CHARS, flash_attention="auto", remat=True,
                               moe_experts=2)
    sc = raw["server_config"]
    sc.update(max_iteration=2, val_freq=1, num_clients_per_iteration=4)
    sc["data_config"] = {"val": {"batch_size": 8, "val_data": "val.json"}}
    raw["client_config"]["data_config"]["train"].update(
        list_of_train_data="train.json")
    cfg_path = tmp_path / "ringlm.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    server = e2e_trainer.main(["-config", str(cfg_path), "-dataPath",
                               longtext, "-outputPath", str(out), "-task",
                               "ringlm", "-device", "cpu"])
    assert server.task.module.block_0.remat
    assert not server.task.module.block_0._MHA_0.use_flash
    records = [json.loads(line) for line in
               (out / "log" / "metrics.jsonl").read_text().splitlines()]
    val = [r["value"] for r in records if r["name"] == "Val loss"]
    assert len(val) == 3 and all(np.isfinite(val))


def test_moe_leaves_carry_across_in_the_jax_ravel_order():
    """``block_<i>/moe_ffn/{router,w_in,w_out}`` with no MLP ``Dense_*`` in
    the block: the port's flat vector is the JAX package's
    ``ravel_pytree`` of the same weights, and back."""
    from jax.flatten_util import ravel_pytree
    from msrflute_tpu.config import ModelConfig as JaxModelConfig
    from msrflute_tpu_torch.models.convert import to_jax_params
    mc = dict(MC, moe_experts=4)
    jt = jax_make_task(JaxModelConfig(model_type="RINGLM", extra=mc))
    pt = make_task(dict(mc, model_type="RINGLM"))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    tp = from_jax_params(pt, jp)
    assert not any(n.startswith("block_0.Dense") for n in tp)
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    back = to_jax_params(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


_PEAK_SCRIPT = """
import sys, torch
from torch.func import vmap, grad_and_value
from msrflute_tpu_torch.models import make_task
task = make_task({"model_type": "RINGLM", "vocab_size": 90, "embed_dim": 128,
                  "num_heads": 4, "head_dim": 32, "mlp_dim": 512,
                  "num_layers": 4, "seq_len": 257, "flash_attention": True,
                  "remat": sys.argv[1] == "1"})
p = task.init_params(0)
K, B = 2, 16
vp = {k: v.expand(K, *v.shape).clone() for k, v in p.items()}
b = {"x": torch.randint(1, 90, (K, B, 257)), "sample_mask": torch.ones(K, B)}
def hwm():
    # this process's own peak resident set (getrusage's ru_maxrss keeps the
    # forking parent's across exec)
    with open("/proc/self/status") as fh:
        return next(int(line.split()[1]) * 1024 for line in fh
                    if line.startswith("VmHWM:"))
base = hwm()
vmap(grad_and_value(task.loss_masked))(vp, b)
print(hwm() - base)
"""


def test_remat_keeps_fewer_activations_under_vmap_grad():
    """``torch.func.grad`` differentiates with ``create_graph``, so a
    backward whose recompute were recorded would keep every block's
    activations alive to the end, as without remat.  Peak resident memory
    of one client step (4 blocks, K = 2, 16 rows of 256 tokens), each mode
    in a fresh process: remat's is under 70 % of the plain step's
    (measured 0.61 against 1.15-1.22 GB, 50-53 %)."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=REPO)
    peak = {}
    for remat in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", _PEAK_SCRIPT, remat],
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True)
        peak[remat] = int(out.stdout.split()[-1])
    assert peak["1"] < 0.7 * peak["0"], peak
