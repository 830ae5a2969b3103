"""The port's LR, CNN_FEMNIST and CIFAR_CNN tasks against the JAX package's,
on weights carried across by
``msrflute_tpu_torch.models.convert.from_jax_params``.

Tolerances: LR logits, loss and grads to ``rtol 1e-5``; the CNNs to
``rtol 1e-4`` / ``atol 1e-6`` (the two frameworks reduce the convolutions
and the 9216- and 4096-wide dense layers in different orders); CIFAR_CNN's
F1 scores to ``rel 1e-6`` (the JAX task sums its counts in float32, the
port in float64, both exact at these counts).  Dropout is off on both
sides: the two random streams cannot match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params

CASES = {
    "lr": ({"model_type": "LR", "num_classes": 4, "input_dim": 8}, 1e-5, 0.0),
    "lr_sigmoid": ({"model_type": "LR", "num_classes": 4, "input_dim": 8,
                    "sigmoid_output": True}, 1e-5, 0.0),
    "cnn": ({"model_type": "CNN", "num_classes": 62, "dropout1": 0.0,
             "dropout2": 0.0}, 1e-4, 1e-6),
    "cifar": ({"model_type": "CIFAR_CNN", "num_classes": 10}, 1e-4, 1e-6),
}


def _tasks(raw):
    extra = {k: v for k, v in raw.items() if k != "model_type"}
    jt = jax_make_task(JaxModelConfig(model_type=raw["model_type"],
                                      extra=dict(extra)))
    pt = make_task(ModelConfig(model_type=raw["model_type"],
                               extra=dict(extra)))
    return jt, pt


def _batch(raw, n=6, seed=0):
    rng = np.random.default_rng(seed)
    if raw["model_type"] == "LR":
        x = rng.normal(size=(n, 8)).astype(np.float32)
    elif raw["model_type"] == "CIFAR_CNN":
        x = rng.integers(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.integers(0, 256, size=(n, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, raw["num_classes"], size=(n,)).astype(np.int32)
    mask = np.ones((n,), np.float32)
    mask[-2:] = 0.0                      # padded rows must not count
    return {"x": x, "y": y, "sample_mask": mask}


def _setup(name):
    raw, rtol, atol = CASES[name]
    jt, pt = _tasks(raw)
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(3)))
    return raw, rtol, atol, jt, pt, jp, from_jax_params(pt, jp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_loss_and_eval_match(name):
    raw, rtol, atol, jt, pt, jp, tp = _setup(name)
    b = _batch(raw)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(pt.apply(tp, tb["x"]).detach().numpy(),
                               np.asarray(jt.apply(jp, jb["x"])),
                               rtol=rtol, atol=atol)
    jl, _ = jt.loss(jp, jb, None, train=False)
    tl = pt.loss_masked(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    js, ts = jt.eval_stats(jp, jb), pt.eval_stats(tp, tb)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match(name):
    raw, rtol, atol, jt, pt, jp, tp = _setup(name)
    b = _batch(raw, seed=1)
    jg = jax.grad(lambda p: jt.loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, None, train=False)[0])(jp)
    tg = grad(pt.loss_masked)(tp, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    want = from_jax_params(pt, jax.device_get(jg))
    for k in want:
        np.testing.assert_allclose(tg[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_weight_carry_across_round_trips(name):
    _, _, _, _, pt, jp, tp = _setup(name)
    back = to_jax_params(tp)
    assert set(back) == set(jp)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          np.asarray(jp[layer][leaf]))
    assert [n for n, _ in pt.param_spec()] == list(tp)


def test_cnn_femnist_parameter_count():
    """P = 1,206,590, the figure the kernel's bound is computed from."""
    _, pt = _tasks({"model_type": "CNN", "num_classes": 62})
    assert pt.layout().numel == 1_206_590


def test_cifar_cnn_f1_scores_match_the_jax_task():
    """Micro F1 (the reference's sklearn ``average='micro'``) and macro F1
    over the classes seen, from eval stats summed over batches, as the JAX
    task finalizes them; micro F1 with one label a sample is the accuracy."""
    _, _, _, jt, pt, jp, tp = _setup("cifar")
    raw = CASES["cifar"][0]
    jsum = tsum = None
    for seed in range(3):
        b = _batch(raw, n=16, seed=seed)
        js = jt.eval_stats(jp, {k: jnp.asarray(v) for k, v in b.items()})
        ts = pt.eval_stats(tp, {k: torch.from_numpy(v) for k, v in b.items()})
        jsum = js if jsum is None else {k: jsum[k] + js[k] for k in js}
        tsum = ts if tsum is None else {k: tsum[k] + ts[k] for k in ts}
    want = jt.finalize_metrics(jax.device_get(jsum))
    got = pt.finalize_metrics({k: v.tolist() for k, v in tsum.items()})
    assert set(got) == set(want) == {"loss", "acc", "f1_score", "f1_macro"}
    for k in want:
        assert got[k].value == pytest.approx(want[k].value, rel=1e-6), k
        assert got[k].higher_is_better == want[k].higher_is_better
    assert got["f1_score"].value == pytest.approx(got["acc"].value)
