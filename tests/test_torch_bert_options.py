"""BERT's model options in the port (``msrflute_tpu_torch/models/bert.py``):
the gathered MLM head (``mlm_head: gathered``, ``gathered_slots``) and the
compute ``dtype``, against the JAX package's ``BertMLMTask`` over HF Flax
at ``tests/test_torch_bert.py``'s widths (2 layers, hidden 32, 2 heads,
vocabulary 1,000, 16 tokens) with the JAX weights carried across and
``premasked`` rows:

- the gathered head's loss, grads and eval stats against the JAX head's:
  ``rtol 1e-5`` (float32 sums in other orders; grads to ``1e-5`` of the
  largest, as in ``test_torch_bert.py``);
- a batch whose masked count exceeds the slots: the port packs and drops
  exactly the JAX package's positions (the slot indices and labels equal);
- ``gathered_slots == seq_len`` is the full head (``1e-6`` relative);
- the default slot count (40 at ``L = 128``, ``p = 0.15``) and the
  range check, as in the JAX task;
- bfloat16 against the JAX package's bfloat16 (full and gathered head):
  the loss within one bfloat16 ulp (``2**-8`` relative) and the grads
  within ``4 * 2**-8`` relative L2.  The two packages round to bfloat16
  at other points: XLA keeps float32 inside a fused chain of elementwise
  ops (the erf GELU, the softmax's exp and sum, the residual adds), the
  port rounds after each op.  Measured: the loss 3.3e-5 apart, the grads
  6.3e-3 (full) and 7.2e-3 (gathered);
- the gathered head in bfloat16 through the port's CLI on
  ``-device cpu`` (DGA with quantization, as ``experiments/mlm_bert``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import grad_and_value

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models.bert import make_bert_mlm_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.device import cpu16_guard
from msrflute_tpu_torch.models.bert import make_bert_task
from test_torch_bert import (L, _batch, _carried, _dga_raw, _model,
                             _token_blob)

BF16_LOSS_TOL = 2.0 ** -8
BF16_GRAD_TOL = 4 * 2.0 ** -8


def _loss_grads(jt, pt, jp, tp, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, False), has_aux=True))(jp)
    with cpu16_guard("cpu", pt.compute_dtype):
        tg, (tl, _) = grad_and_value(pt.loss_and_aux, has_aux=True)(tp, tb)
    return (float(tl), float(jl), pt.layout().flatten(tg).numpy(),
            np.asarray(ravel_pytree(jg)[0]), jb, tb)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _overflow_batch():
    """Row 0 labels 12 of its 16 positions, row 2 none."""
    b = _batch(seed=4)
    b["y"][0] = np.where(np.arange(L) % 4 != 1, b["x"][0], -100)
    b["y"][2] = -100
    return b


@pytest.mark.parametrize("slots", [None, 3])
def test_gathered_head_matches_jax(slots):
    over = {"mlm_head": "gathered"}
    if slots is not None:
        over["gathered_slots"] = slots
    jt, pt, jp, tp = _carried(premasked=True, **over)
    assert pt.gathered_slots == jt.gathered_slots == (slots or 8)
    tl, jl, tg, jg, jb, tb = _loss_grads(jt, pt, jp, tp, _overflow_batch())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    want = jax.jit(jt.eval_stats)(jp, jb)
    with torch.no_grad():
        got = pt.eval_stats(tp, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_overflow_drops_the_jax_packages_positions():
    """12 labelled positions in 3 slots: the first 3 in order are kept and
    the other 9 dropped, in both packages; a row without labels fills its
    slots with -100."""
    jt, pt, _, _ = _carried(premasked=True, mlm_head="gathered",
                            gathered_slots=3)
    labels = np.where(_overflow_batch()["sample_mask"][:, None] > 0,
                      _overflow_batch()["y"], -100)
    hidden = np.random.default_rng(0).normal(size=(4, L, 32)).astype(
        np.float32)
    jh, jlab = jt._gather_masked(jnp.asarray(hidden), jnp.asarray(labels))
    idx, tlab = pt.gather_masked(torch.from_numpy(labels).long())
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(
        np.take_along_axis(hidden, idx.numpy()[..., None], axis=1),
        np.asarray(jh))
    assert (tlab.numpy()[0] == labels[0][labels[0] != -100][:3]).all()
    assert (tlab.numpy()[2] == -100).all()


def test_all_slots_are_the_full_head():
    _, full, _, tp = _carried(premasked=True)
    _, gathered, _, _ = _carried(premasked=True, mlm_head="gathered",
                                 gathered_slots=L)
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    g_full, (l_full, _) = grad_and_value(full.loss_and_aux,
                                         has_aux=True)(tp, tb)
    g_gath, (l_gath, _) = grad_and_value(gathered.loss_and_aux,
                                         has_aux=True)(tp, tb)
    assert abs(float(l_gath) - float(l_full)) <= 1e-6 * float(l_full)
    assert _rel(full.layout().flatten(g_gath).numpy(),
                full.layout().flatten(g_full).numpy()) <= 1e-6
    with torch.no_grad():
        a, b = full.eval_stats(tp, tb), gathered.eval_stats(tp, tb)
    for k in a:
        np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-6)


@pytest.mark.parametrize("slots", [0, 129])
def test_default_slots_and_their_range_as_in_the_jax_task(slots):
    shipped = {"max_seq_length": 128, "mlm_probability": 0.15,
               "mlm_head": "gathered", "vocab_size": 50, "hidden_size": 8,
               "num_hidden_layers": 1, "num_attention_heads": 2}
    for make, cfg in ((make_bert_task, ModelConfig),
                      (make_bert_mlm_task, JaxModelConfig)):
        assert make(cfg.from_dict({"model_type": "BERT", "BERT": {
            "model": shipped}})).gathered_slots == 40
        with pytest.raises(ValueError, match="gathered_slots must be in"):
            make(cfg.from_dict({"model_type": "BERT", "BERT": {
                "model": dict(shipped, gathered_slots=slots)}}))


@pytest.mark.parametrize("head", ["full", "gathered"])
def test_bfloat16_matches_jax_bfloat16(head):
    jt, pt, jp, tp = _carried(premasked=True, dtype="bfloat16",
                              mlm_head=head)
    assert pt.compute_dtype == torch.bfloat16
    tl, jl, tg, jg, _, _ = _loss_grads(jt, pt, jp, tp, _batch())
    assert abs(tl - jl) <= BF16_LOSS_TOL * abs(jl), (tl, jl)
    assert _rel(tg, jg) <= BF16_GRAD_TOL
    assert tg.dtype == np.float32 and np.isfinite(tg).all()


def test_model_config_dtype_reaches_bert_unless_its_block_sets_one():
    """``parse_dtype(bert_cfg if "dtype" in bert_cfg else model_config)``."""
    m = _model()
    m["dtype"] = "bfloat16"
    assert make_bert_task(ModelConfig.from_dict(m)).compute_dtype == \
        torch.bfloat16
    m = _model(dtype="float32")
    m["dtype"] = "bfloat16"
    assert make_bert_task(ModelConfig.from_dict(m)).compute_dtype == \
        torch.float32


def test_cli_runs_the_gathered_head_in_bfloat16(tmp_path):
    import yaml
    from msrflute_tpu_torch import e2e_trainer
    _token_blob(tmp_path / "train.json", 6, 0)
    _token_blob(tmp_path / "val.json", 2, 1)
    raw = _dga_raw(1, local_dp=True, quant=True)
    raw["model_config"]["BERT"]["model"].update(
        mlm_head="gathered", gathered_slots=8, dtype="bfloat16")
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(tmp_path / "cfg.yaml"),
                               "-dataPath", str(tmp_path), "-outputPath",
                               str(tmp_path / "out"), "-device", "cpu"])
    assert server.task.mlm_head == "gathered"
    assert server.task.compute_dtype == torch.bfloat16
    records = [json.loads(line) for line in (
        tmp_path / "out" / "log" / "metrics.jsonl").read_text().splitlines()]
    val = [r["value"] for r in records if r["name"] == "Val loss"]
    assert len(val) == 2 and all(np.isfinite(val))
    assert any(r["name"] == "Quantization Thresh." for r in records)
