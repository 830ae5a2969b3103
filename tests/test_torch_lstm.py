"""The port's Shakespeare LSTM (``msrflute_tpu_torch/models/nlp.py``,
``model_type: RNN``) against the JAX package's ``_ShakespeareLSTM`` (two
flax ``OptimizedLSTMCell``s under ``nn.RNN``), on weights carried across
by ``models/convert.py`` under flax's own names.

Tolerances: logits, loss and gradients to ``rtol 1e-5`` of the largest
entry at hidden 16 and 12 chars; the forward at the published widths
(vocab 90, embed 8, hidden 256, 80 chars) to ``rtol 1e-5``.  Only the order
of the float32 sums differs: flax adds the four gates' products in one
concatenated product, as the port does, but the two frameworks' GEMMs
split the sums differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.data.user_blob import UserBlob
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params

SMALL = {"model_type": "RNN", "hidden_dim": 16, "seq_len": 12}
PUBLISHED = {"model_type": "RNN", "vocab_size": 90, "embed_dim": 8,
             "hidden_dim": 256, "seq_len": 80}
RTOL = 1e-5


def _tasks(raw):
    extra = {k: v for k, v in raw.items() if k != "model_type"}
    jt = jax_make_task(JaxModelConfig(model_type=raw["model_type"],
                                      extra=dict(extra)))
    pt = make_task(ModelConfig(model_type=raw["model_type"],
                               extra=dict(extra)))
    return jt, pt


def _live_params(jt, seed=3):
    """JAX init with the hidden biases redrawn (flax starts them at 0)."""
    rng = np.random.default_rng(seed)
    params = jax.device_get(jax.jit(jt.init_params)(
        jax.random.PRNGKey(seed)))

    def redraw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['bias']"):
            return rng.normal(0.0, 0.3, leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(n, L, seed):
    """Char ids with 0-padded tails and one padded row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 90, (n, L)).astype(np.int32)
    for i, keep in enumerate(rng.integers(2, L + 1, n)):
        x[i, keep:] = 0
    mask = np.ones((n,), np.float32)
    mask[-1] = 0.0
    return {"x": x, "sample_mask": mask}


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def small():
    jt, pt = _tasks(SMALL)
    jp = _live_params(jt)
    return jt, pt, jp, from_jax_params(pt, jp)


def test_logits_loss_and_eval_match(small):
    jt, pt, jp, tp = small
    b = _batch(4, 12, 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    x = b["x"][:, :-1]
    _close(pt.apply(tp, torch.from_numpy(x).long()).detach().numpy(),
           jax.jit(jt.module.apply)({"params": jp}, jnp.asarray(x)))
    jl, _ = jax.jit(lambda p, b: jt.loss(p, b, None, train=False))(jp, jb)
    assert float(pt.loss_masked(tp, tb)) == pytest.approx(float(jl),
                                                          rel=RTOL)
    js, ts = jax.jit(jt.eval_stats)(jp, jb), pt.eval_stats(tp, tb)
    assert set(js) == set(ts)
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=RTOL)


def test_grads_match(small):
    jt, pt, jp, tp = small
    b = _batch(4, 12, 1)
    jg = jax.jit(jax.grad(lambda p: jt.loss(
        p, {k: jnp.asarray(v) for k, v in b.items()}, None,
        train=False)[0]))(jp)
    tg = grad(pt.loss_masked)(tp, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    want = from_jax_params(pt, jax.device_get(jg))
    assert set(tg) == set(want)
    for k in want:
        _close(tg[k].numpy(), want[k].numpy())


def test_explicit_targets_match(small):
    """fed_shakespeare ships ``y`` beside ``x``: position t of ``x`` is
    trained to predict ``y[t]``, ``tok_mask`` marks the real targets."""
    jt, pt, jp, tp = small
    b = _batch(3, 12, 2)
    y = np.roll(b["x"], -1, axis=1)
    b.update(y=y, tok_mask=(y != 0).astype(np.int32))
    jl, _ = jax.jit(lambda p, b: jt.loss(p, b, None, train=False))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl = pt.loss_masked(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tl) == pytest.approx(float(jl), rel=RTOL)


def test_clients_under_vmap_equal_one_at_a_time(small):
    _, pt, _, tp = small
    K = 3
    params = {k: torch.stack([v * (1.0 + 0.1 * i) for i in range(K)])
              for k, v in tp.items()}
    batches = [_batch(4, 12, 10 + i) for i in range(K)]
    stacked = {k: torch.stack([torch.from_numpy(b[k]) for b in batches])
               for k in batches[0]}
    fn = grad_and_value(pt.loss_and_aux, has_aux=True)
    gv, (lv, _) = vmap(fn)(params, stacked)
    for i in range(K):
        g1, (l1, _) = fn({k: v[i] for k, v in params.items()},
                         {k: torch.from_numpy(v)
                          for k, v in batches[i].items()})
        assert float(lv[i]) == pytest.approx(float(l1), rel=1e-6)
        for k in g1:
            _close(gv[k][i].numpy(), g1[k].numpy(), rtol=1e-6)


def test_published_widths_forward_matches():
    """``experiments/nlp_rnn_fedshakespeare/config.yaml``: P = 820,522
    (kernel B1's row width on this path), leaf for leaf as
    ``jax.eval_shape`` gives it, and the forward over 79 chars."""
    jt, pt = _tasks(PUBLISHED)
    jp = _live_params(jt, seed=5)
    tp = from_jax_params(pt, jp)
    assert pt.layout().numel == 820_522 == sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(jp))
    x = _batch(3, 80, 4)["x"][:, :-1]
    got = pt.apply(tp, torch.from_numpy(x).long()).detach().numpy()
    want = jax.jit(jt.module.apply)({"params": jp}, jnp.asarray(x))
    assert got.shape == (3, 79, 90)
    _close(got, want)


def test_weight_carry_across_round_trips(small):
    _, pt, jp, tp = small
    back = to_jax_params(tp)
    flat = dict(jax.tree_util.tree_leaves_with_path(jp))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == \
        set(map(jax.tree_util.keystr, got))
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf, np.asarray(flat[path]))
    # the flat [P] vector is the JAX package's ravel_pytree order
    names = [n for n, _ in pt.param_spec()]
    assert names == sorted(names, key=lambda n: n.split("."))


def test_init_follows_the_flax_initializers():
    _, pt = _tasks(PUBLISHED)
    p = pt.init_params(0)
    w = p["OptimizedLSTMCell_1.hf.kernel"]
    torch.testing.assert_close(w.T @ w, torch.eye(256), atol=1e-4, rtol=0)
    assert float(p["OptimizedLSTMCell_0.hi.bias"].abs().max()) == 0.0
    assert "OptimizedLSTMCell_0.ii.bias" not in p
    assert float(p["Embed_0.embedding"].std()) == pytest.approx(
        (1 / 8) ** 0.5, rel=0.05)


def test_make_dataset_encodes_chars_as_the_jax_task():
    jt, pt = _tasks(SMALL)
    lines = ["To be, or not to be", "ay", "Wherefore art thou Romeo?~"]
    blob = UserBlob(["a", "b"], [2, 1], [lines[:2], lines[2:]])
    got = pt.make_dataset(blob)
    want = jt.make_dataset(blob, ModelConfig(model_type="RNN"), "train")
    for i in range(2):
        for k in ("x", "tok_mask"):
            np.testing.assert_array_equal(got.user_arrays(i)[k],
                                          want.user_arrays(i)[k])
