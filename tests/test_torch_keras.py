"""The port's Keras-style API (bigdl_tpu_torch/keras/) against the JAX
package's (tests/test_keras_api.py's cases): shape inference, `summary`
and the errors; forward outputs on the same seeded weights (fp32,
rtol 1e-5, atol 1e-6); `fit`/`evaluate`/`predict` of a
`Sequential([Embedding, Bidirectional(LSTM), Dense])` and of a
two-input functional `Model` from the same weights and data, the
trained weights, scores and predictions within fp32 1e-4 (the two
frameworks' sums in different orders, over 8 Adam steps); the
bidirectional layer's backward half being the backward RNN's final
state; the merge maths, shared-layer reuse and diamonds.

Both sides build from one seed: the JAX module's variable shapes from
`jax.eval_shape(module.init, key)` filled with seeded numpy, carried
across by `models/convert.variables_from_jax`. The port's models run
on the CPU (`device="cpu"`)."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as jk
from bigdl_tpu_torch import keras as tk
from bigdl_tpu_torch.models.convert import tree_leaves, variables_from_jax

KEY = jax.random.PRNGKey(0)
FWD = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=1e-5)


def _seeded(module, seed=0):
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(path[-1].key) if path else ""
        if name == "running_var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (rng.randn(*a.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(module.init, KEY))


def _pair(layers_of, **kw):
    """The JAX and port Sequential over `layers_of(keras_package)`, built,
    with the same seeded variables."""
    jm = jk.Sequential(layers_of(jk))
    tm = tk.Sequential(layers_of(tk), device="cpu", **kw)
    jmod, tmod = jm.build(), tm.build()
    jv = _seeded(jmod)
    jmod.variables = jv
    tmod.variables = variables_from_jax(jv, device="cpu")
    return jm, tm


def _forward_equal(jm, tm, x):
    jout, _ = jm.module.apply(jm.module.variables, x)
    tout, _ = tm.module.apply(tm.module.variables, torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FWD)
    return tout


SHAPE_CASES = {
    "conv_chain": (lambda k: [
        k.Conv2D(4, 3, input_shape=(8, 8, 1), activation="relu"),
        k.MaxPooling2D(2), k.Flatten(), k.Dense(10, activation="softmax")],
        (2, 8, 8, 1), (10,)),
    "same_padding": (lambda k: [
        k.Conv2D(3, 3, padding="same", input_shape=(7, 7, 2))],
        (2, 7, 7, 2), (7, 7, 3)),
    "avg_pool_same": (lambda k: [
        k.AveragePooling2D(3, 2, padding="same", input_shape=(7, 7, 2)),
        k.GlobalAveragePooling2D()], (2, 7, 7, 2), (2,)),
    "embedding_lstm": (lambda k: [
        k.Embedding(50, 8, input_length=12), k.LSTM(16),
        k.Dense(2, activation="log_softmax")], (3, 12), (2,)),
    "conv3d_chain": (lambda k: [
        k.Conv3D(4, 2, input_shape=(4, 6, 6, 1), activation="relu"),
        k.MaxPooling3D(2), k.Flatten(), k.Dense(3)], (2, 4, 6, 6, 1), (3,)),
    "upsampling": (lambda k: [k.UpSampling2D(2, input_shape=(3, 3, 2))],
                   (2, 3, 3, 2), (6, 6, 2)),
    "global_max_pool": (lambda k: [
        k.GlobalMaxPooling2D(input_shape=(5, 5, 7))], (2, 5, 5, 7), (7,)),
    "bidirectional": (lambda k: [
        k.Embedding(30, 8, input_length=10), k.Bidirectional(k.LSTM(12)),
        k.Dense(2)], (3, 10), (2,)),
    "gru_sequences": (lambda k: [
        k.Embedding(30, 8, input_length=10),
        k.GRU(6, return_sequences=True)], (3, 10), (10, 6)),
    "simple_rnn_bi_gru": (lambda k: [
        k.Bidirectional(k.GRU(5), input_shape=(6, 4)), k.RepeatVector(3),
        k.SimpleRNN(4)], (2, 6, 4), (4,)),
    "pad_crop": (lambda k: [
        k.ZeroPadding2D((1, 2), input_shape=(4, 4, 3)),
        k.Cropping2D(((1, 0), (2, 1)))], (2, 4, 4, 3), (5, 5, 3)),
    "permute": (lambda k: [k.Permute((2, 1, 3), input_shape=(3, 4, 5))],
                (2, 3, 4, 5), (4, 3, 5)),
    "permute_3cycle": (lambda k: [
        k.Permute((3, 1, 2), input_shape=(3, 4, 5))], (1, 3, 4, 5),
        (5, 3, 4)),
    "repeat_vector": (lambda k: [k.RepeatVector(5, input_shape=(7,))],
                      (2, 7), (5, 7)),
    "bn_dropout_reshape": (lambda k: [
        k.InputLayer((4, 4, 2)), k.BatchNormalization(), k.Dropout(0.3),
        k.Activation("tanh"), k.Reshape((8, 4)), k.Flatten()],
        (2, 4, 4, 2), (32,)),
}


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_shapes_and_forward_match_jax(name):
    layers_of, in_shape, out_shape = SHAPE_CASES[name]
    jm, tm = _pair(layers_of)
    assert tm.output_shape == jm.output_shape == out_shape
    assert tm.summary() == jm.summary()
    rng = np.random.RandomState(3)
    x = (rng.randint(0, 30, in_shape).astype(np.int32)
         if len(in_shape) == 2 and name in ("embedding_lstm",
                                            "bidirectional", "gru_sequences")
         else rng.rand(*in_shape).astype(np.float32))
    out = _forward_equal(jm, tm, x)
    assert tuple(out.shape) == in_shape[:1] + out_shape


def test_permute_and_repeat_are_the_numpy_maths():
    x = np.random.RandomState(1).rand(2, 3, 4, 5).astype(np.float32)
    for dims, perm in (((2, 1, 3), (0, 2, 1, 3)), ((3, 1, 2), (0, 3, 1, 2))):
        m = tk.Sequential([tk.Permute(dims, input_shape=(3, 4, 5))],
                          device="cpu")
        out, _ = m.module.apply(m.module.init(device="cpu"),
                                torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(), x.transpose(perm))
    v = np.random.RandomState(0).rand(2, 7).astype(np.float32)
    m = tk.Sequential([tk.RepeatVector(5, input_shape=(7,))], device="cpu")
    out, _ = m.module.apply(m.module.init(device="cpu"), torch.from_numpy(v))
    np.testing.assert_array_equal(out[:, 3].numpy(), v)


def test_errors_as_jax():
    with pytest.raises(ValueError, match="input_shape"):
        tk.Sequential([tk.Dense(4)], device="cpu")
    with pytest.raises(ValueError, match="flat input"):
        tk.Sequential([tk.Dense(4, input_shape=(2, 3))],
                      device="cpu").build()
    with pytest.raises(ValueError, match="unknown activation"):
        tk.Sequential([tk.Dense(4, activation="nope", input_shape=(3,))],
                      device="cpu").build()
    with pytest.raises(NotImplementedError, match="uniform scale"):
        tk.UpSampling2D((2, 3))
    with pytest.raises(RuntimeError, match="compile"):
        tk.Sequential([tk.Dense(2, input_shape=(3,))], device="cpu").fit(
            np.zeros((4, 3), np.float32), np.zeros(4, np.int32))


def _sentiment(n, seq, vocab, seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n)
    x = rng.randint(1, vocab // 2, (n, seq)) + y[:, None] * (vocab // 2)
    return x.astype(np.float32), y.astype(np.int32)


def _params_close(jmod, tmod):
    jl = jax.tree_util.tree_leaves(jmod.variables["params"])
    tl = tree_leaves(tmod.variables["params"])
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TRAJ)


def test_bidirectional_lstm_fit_evaluate_predict_match_jax():
    vocab, seq = 40, 8
    jm, tm = _pair(lambda k: [
        k.Embedding(vocab, 8, input_length=seq),
        k.Bidirectional(k.LSTM(8)), k.Dense(2, activation="log_softmax")])
    x, y = _sentiment(64, seq, vocab, 0)
    vx, vy = _sentiment(32, seq, vocab, 1)
    before = tm.predict(vx, batch_size=16)
    for m in (jm, tm):
        m.compile("adam", "nll", metrics=["accuracy"])
        m.fit(x, y, batch_size=16, epochs=2)
    _params_close(jm.module, tm.module)
    js, ts = jm.evaluate(vx, vy, batch_size=16), tm.evaluate(vx, vy,
                                                              batch_size=16)
    assert set(js) == set(ts) == {"Top1Accuracy"}
    np.testing.assert_allclose(ts["Top1Accuracy"], js["Top1Accuracy"])
    jp, tp = jm.predict(vx, batch_size=16), tm.predict(vx, batch_size=16)
    assert isinstance(tp, np.ndarray) and tp.shape == (32, 2)
    np.testing.assert_allclose(tp, np.asarray(jp), **TRAJ)
    np.testing.assert_array_equal(tm.predict_classes(vx),
                                  np.asarray(jm.predict_classes(vx)))
    assert not np.allclose(before, tp)     # the fit moved the model


def test_functional_two_input_model_fit_matches_jax():
    def build(k):
        a, b = k.Input(shape=(6,)), k.Input(shape=(6,))
        x = k.Dense(8, activation="relu")(a)
        y = k.Dense(8, activation="relu")(b)
        out = k.Dense(3, activation="log_softmax")(k.merge(
            [x, y], mode="concat"))
        return a, b, out

    ja, jb, jout = build(jk)
    ta, tb, tout = build(tk)
    jm = jk.Model([ja, jb], jout)
    tm = tk.Model([ta, tb], tout, device="cpu")
    assert tm.output_shape == jm.output_shape == (3,)
    jv = _seeded(jm.module)
    jm.module.variables = jv
    tm.module.variables = variables_from_jax(jv, device="cpu")
    rng = np.random.RandomState(0)
    xa = rng.rand(64, 6).astype(np.float32)
    xb = rng.rand(64, 6).astype(np.float32)
    labels = rng.randint(0, 3, 64)
    for m in (jm, tm):
        m.compile("adam", "nll", metrics=["accuracy"])
        m.fit([xa, xb], labels, batch_size=16, epochs=2)
    _params_close(jm.module, tm.module)
    js = jm.evaluate([xa, xb], labels, batch_size=16)
    ts = tm.evaluate([xa, xb], labels, batch_size=16)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], **TRAJ)
    np.testing.assert_allclose(tm.predict([xa[:8], xb[:8]]),
                               np.asarray(jm.predict([xa[:8], xb[:8]])),
                               **TRAJ)


def test_backward_half_is_the_final_state():
    """The bidirectional last state: the forward RNN's final step and
    the backward RNN's final step (at input position 0 after
    BiRecurrent re-flips it), as tests/test_keras_api.py pins it."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.keras.layers_extra import _BiLastState

    x = torch.from_numpy(np.random.RandomState(5).randn(3, 7, 4).astype(
        np.float32))
    bi = nn.BiRecurrent(nn.LSTM(4, 6), nn.LSTM(4, 6))
    variables = bi.init(torch.Generator().manual_seed(9), device="cpu")
    seq, _ = bi.apply(variables, x)
    out, _ = _BiLastState(6).apply({"params": {}, "state": {}}, seq)
    assert out.shape == (3, 12)
    fwd, _ = nn.Recurrent(nn.LSTM(4, 6)).apply(
        {"params": variables["params"]["fwd"], "state": {}}, x)
    bwd, _ = nn.Recurrent(nn.LSTM(4, 6)).apply(
        {"params": variables["params"]["bwd"], "state": {}}, x.flip(1))
    expect = torch.cat([fwd[:, -1], bwd[:, -1]], dim=-1)
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(out, seq[:, -1])

    m = tk.Sequential([tk.Bidirectional(tk.LSTM(6), input_shape=(7, 4))],
                      device="cpu")
    found = []

    def walk(mod):
        found.append(type(mod).__name__)
        for child in getattr(mod, "modules_", []):
            walk(child)

    walk(m.build())
    assert "_BiLastState" in found and "Select" not in found


def test_merge_layers_math():
    rng = np.random.RandomState(1)
    xa = rng.rand(4, 5).astype(np.float32)
    xb = rng.rand(4, 5).astype(np.float32)
    cases = [(tk.Multiply(), xa * xb), (tk.Subtract(), xa - xb),
             (tk.Maximum(), np.maximum(xa, xb)),
             (tk.Minimum(), np.minimum(xa, xb)),
             (tk.Average(), (xa + xb) / 2),
             (tk.Concatenate(), np.concatenate([xa, xb], axis=1)),
             (tk.Dot(), (xa * xb).sum(1))]
    for layer, want in cases:
        a, b = tk.Input(shape=(5,)), tk.Input(shape=(5,))
        g = tk.Model([a, b], layer([a, b]), device="cpu").module
        got, _ = g.apply(g.init(device="cpu"), torch.from_numpy(xa),
                         torch.from_numpy(xb))
        np.testing.assert_allclose(got.numpy().reshape(want.shape), want,
                                   rtol=1e-6, atol=1e-6)
    a, b = tk.Input(shape=(5,)), tk.Input(shape=(5,))
    g = tk.Model([a, b], tk.merge([a, b], mode="sum"),
                 device="cpu").module
    got, _ = g.apply(g.init(device="cpu"), torch.from_numpy(xa),
                     torch.from_numpy(xb))
    np.testing.assert_allclose(got.numpy(), xa + xb, rtol=1e-6)


def test_shared_layer_reuse_and_diamond_match_jax():
    def build(k, **kw):
        a, b = k.Input(shape=(5,)), k.Input(shape=(5,))
        shared = k.Dense(4)
        h = k.Add()([shared(a), shared(b)])
        z = k.Add()([k.Dense(4, activation="relu")(h), h])   # diamond
        return k.Model([a, b], k.Dense(2)(z), **kw), shared

    (jm, _), (tm, shared) = build(jk), build(tk, device="cpu")
    jv = _seeded(jm.module)
    tv = variables_from_jax(jv, device="cpu")
    # the shared Dense is one entry (the relu Dense is a Sequential)
    assert set(tv["params"]) == set(jv["params"])
    assert len([k for k in tv["params"] if "Linear" in k]) == 2
    xa = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    xb = np.random.RandomState(1).rand(3, 5).astype(np.float32)
    o1, _ = tm.module.apply(tv, torch.from_numpy(xa), torch.from_numpy(xb))
    o2, _ = tm.module.apply(tv, torch.from_numpy(xb), torch.from_numpy(xa))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6)
    jo, _ = jm.module.apply(jv, xa, xb)
    np.testing.assert_allclose(o1.numpy(), np.asarray(jo), **FWD)
    with pytest.raises(ValueError, match="same input shape"):
        shared(tk.Input(shape=(7,)))


def test_functional_errors():
    a, b = tk.Input(shape=(4,)), tk.Input(shape=(3,))
    with pytest.raises(ValueError, match="identical shapes"):
        tk.Add()([a, b])
    with pytest.raises(TypeError, match="merge layer"):
        tk.Dense(2)([a, b])
    with pytest.raises(ValueError, match="unknown merge mode"):
        tk.merge([a, a], mode="frobnicate")
    with pytest.raises(ValueError, match="out of range"):
        tk.Concatenate(axis=-2)([a, a])
    with pytest.raises(TypeError, match="exactly 2"):
        tk.Subtract()([a, a, a])
