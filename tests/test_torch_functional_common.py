"""`nn.functional.common` and the common layers of the port
(`nn.layer.common`) against the reference's: each function of the
reference's nn/functional/common.py and each layer of its
nn/layer/common.py on the same numpy inputs (f32; the layers' weights
carried over with `load_jax_params`). The random ones (the dropouts) draw
from a `torch.Generator` where the reference draws from its JAX key, so
their masks differ: they are held to the reference in eval mode and to
its formulas on the mask they drew, and shown never to touch torch's
global RNG."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.nn import functional as TF
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32 on both sides; sums (normalize, cosine, bilinear, the resize
# contractions) are taken in other orders
RTOL, ATOL = 1e-5, 1e-6


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _functional_cases():
    """id -> (function name, args builder(rng) -> tuple of numpy arrays or
    python values, kwargs)."""
    return {
        "linear": ("linear", lambda r: (_f32(r, 3, 4), _f32(r, 4, 5),
                                        _f32(r, 5)), {}),
        "linear_no_bias": ("linear", lambda r: (_f32(r, 2, 3, 4),
                                                _f32(r, 4, 5)), {}),
        "dropout_eval": ("dropout", lambda r: (_f32(r, 4, 6),),
                         dict(p=0.3, training=False)),
        "dropout_eval_downscale": ("dropout", lambda r: (_f32(r, 4, 6),),
                                   dict(p=0.3, training=False,
                                        mode="downscale_in_infer")),
        "dropout_p1": ("dropout", lambda r: (_f32(r, 4, 6),),
                       dict(p=1.0, training=True)),
        "dropout2d_eval": ("dropout2d", lambda r: (_f32(r, 2, 3, 4, 4),),
                           dict(p=0.5, training=False)),
        "dropout3d_eval": ("dropout3d", lambda r: (_f32(r, 2, 3, 2, 2, 2),),
                           dict(p=0.5, training=False)),
        "alpha_dropout_eval": ("alpha_dropout", lambda r: (_f32(r, 4, 6),),
                               dict(p=0.5, training=False)),
        "embedding": ("embedding", lambda r: (
            r.randint(0, 10, (3, 4)).astype(np.int64), _f32(r, 10, 5)), {}),
        "embedding_padding": ("embedding", lambda r: (
            np.array([[0, 3, 0], [7, 0, 2]], np.int64), _f32(r, 10, 5)),
            dict(padding_idx=0)),
        "one_hot": ("one_hot", lambda r: (
            r.randint(0, 6, (2, 3)).astype(np.int64),), dict(num_classes=6)),
        "label_smooth": ("label_smooth", lambda r: (
            np.eye(5, dtype=np.float32)[[1, 3, 0]],), dict(epsilon=0.2)),
        "label_smooth_prior": ("label_smooth", lambda r: (
            np.eye(4, dtype=np.float32)[[1, 2]],
            np.full((4,), 0.25, np.float32)), dict(epsilon=0.1)),
        "pad_constant": ("pad", lambda r: (_f32(r, 2, 3, 4, 5),
                                           [1, 2, 0, 3]),
                         dict(mode="constant", value=1.5)),
        "pad_reflect_nhwc": ("pad", lambda r: (_f32(r, 2, 4, 5, 3),
                                               [2, 1, 1, 3]),
                             dict(mode="reflect", data_format="NHWC")),
        "pad_replicate_all": ("pad", lambda r: (_f32(r, 3, 4),
                                                [1, 0, 2, 2]),
                              dict(mode="replicate")),
        "pad_circular": ("pad", lambda r: (_f32(r, 2, 3, 6), [2, 3]),
                         dict(mode="circular", data_format="NCL")),
        "interpolate_nearest": ("interpolate", lambda r: (
            _f32(r, 2, 3, 5, 7),), dict(size=[3, 13], mode="nearest")),
        "interpolate_nearest_scale": ("interpolate", lambda r: (
            _f32(r, 1, 2, 4, 4),), dict(scale_factor=2, mode="nearest")),
        "interpolate_bilinear_align": ("interpolate", lambda r: (
            _f32(r, 2, 3, 5, 7),), dict(size=[9, 4], mode="bilinear",
                                        align_corners=True)),
        "interpolate_bilinear": ("interpolate", lambda r: (
            _f32(r, 2, 3, 5, 7),), dict(size=[9, 11], mode="bilinear")),
        "interpolate_bilinear_down": ("interpolate", lambda r: (
            _f32(r, 2, 3, 8, 8),), dict(scale_factor=0.5, mode="bilinear")),
        "interpolate_bicubic_nhwc": ("interpolate", lambda r: (
            _f32(r, 2, 5, 6, 3),), dict(size=[7, 4], mode="bicubic",
                                        data_format="NHWC")),
        "interpolate_trilinear": ("interpolate", lambda r: (
            _f32(r, 1, 2, 3, 4, 5),), dict(size=[5, 4, 3],
                                           mode="trilinear",
                                           data_format="NCDHW")),
        "upsample": ("upsample", lambda r: (_f32(r, 1, 2, 3, 3),),
                     dict(scale_factor=2, mode="nearest")),
        "normalize": ("normalize", lambda r: (_f32(r, 3, 4, 5),),
                      dict(p=2, axis=1)),
        "normalize_p1": ("normalize", lambda r: (_f32(r, 3, 4),),
                         dict(p=1, axis=-1)),
        "cosine_similarity": ("cosine_similarity", lambda r: (
            _f32(r, 3, 4, 5), _f32(r, 3, 4, 5)), dict(axis=1)),
        "pixel_shuffle": ("pixel_shuffle", lambda r: (_f32(r, 2, 8, 3, 3),
                                                      2), {}),
        "pixel_shuffle_nhwc": ("pixel_shuffle", lambda r: (
            _f32(r, 2, 3, 3, 8), 2), dict(data_format="NHWC")),
        "pixel_unshuffle": ("pixel_unshuffle", lambda r: (
            _f32(r, 2, 2, 6, 4), 2), {}),
        "pixel_unshuffle_nhwc": ("pixel_unshuffle", lambda r: (
            _f32(r, 2, 6, 4, 2), 2), dict(data_format="NHWC")),
        "channel_shuffle": ("channel_shuffle", lambda r: (
            _f32(r, 2, 6, 3, 3), 3), {}),
        "channel_shuffle_nhwc": ("channel_shuffle", lambda r: (
            _f32(r, 2, 3, 3, 6), 2), dict(data_format="NHWC")),
        "unfold": ("unfold", lambda r: (_f32(r, 2, 3, 6, 7), [2, 3]),
                   dict(strides=[1, 2], paddings=1, dilations=1)),
        "unfold_pad4": ("unfold", lambda r: (_f32(r, 1, 2, 5, 5), 3),
                        dict(paddings=[1, 0, 2, 1], dilations=[1, 2])),
        "fold": ("fold", lambda r: (_f32(r, 2, 12, 25), [4, 5], [2, 3]),
                 dict(strides=1, paddings=1)),
        "bilinear": ("bilinear", lambda r: (_f32(r, 4, 3), _f32(r, 4, 5),
                                            _f32(r, 2, 3, 5), _f32(r, 2)),
                     {}),
        "diag_embed": ("diag_embed", lambda r: (_f32(r, 2, 3),), {}),
        "diag_embed_offset": ("diag_embed", lambda r: (_f32(r, 2, 3),),
                              dict(offset=-1, dim1=0, dim2=2)),
    }


def _to_ref(a):
    return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a


def _to_port(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _value(out):
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


@pytest.mark.parametrize("name", sorted(_functional_cases()))
def test_functional_matches_the_reference(name):
    fn, build, kw = _functional_cases()[name]
    args = build(np.random.RandomState(0))
    want = _value(getattr(JF, fn)(*map(_to_ref, args), **kw))
    got = getattr(TF, fn)(*map(_to_port, args), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    if name == "embedding_padding":  # the reference's forward: zeros
        assert not got[0, 0].any() and got[0, 1].any()


def test_embedding_padding_row_values_stay_out_of_the_forward():
    """torch's ``padding_idx`` alone would return the row's values; the
    reference multiplies the output by the mask, and so does the port."""
    w = torch.ones(4, 2)
    ids = torch.tensor([[0, 1]])
    assert torch.nn.functional.embedding(ids, w, padding_idx=0)[0, 0].any()
    assert not TF.embedding(ids, w, padding_idx=0)[0, 0].any()
    out = TF.embedding(ids, w.requires_grad_(), padding_idx=0, sparse=True)
    out.sum().backward()
    assert w.grad.is_sparse and w.grad._indices().tolist() == [[1]]


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]])
def test_dropout_draws_from_its_generator_with_the_references_formula(
        mode, axis):
    x = torch.from_numpy(_f32(np.random.RandomState(1), 4, 5, 6)) + 3.0
    state = torch.get_rng_state()
    outs = [TF.dropout(x, 0.4, axis=axis, mode=mode,
                       generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert torch.equal(torch.get_rng_state(), state)  # global RNG untouched
    assert torch.equal(outs[0], outs[1])  # the same seed, the same mask
    kept = outs[0] != 0
    scale = 1 / 0.6 if mode == "upscale_in_train" else 1.0
    torch.testing.assert_close(outs[0][kept], (x * scale)[kept])
    if axis is not None:  # one draw per slice along the axes
        axes = [axis] if isinstance(axis, int) else axis
        other = tuple(d for d in range(3) if d not in axes)
        assert torch.equal(kept.all(dim=other), kept.any(dim=other))
    with pytest.raises(ValueError, match="generator"):
        TF.dropout(x, 0.4, axis=axis, mode=mode)


def test_dropout2d_3d_and_alpha_dropout_formulas():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_f32(rng, 2, 3, 4, 4)) + 2.0
    out = TF.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(1))
    kept = (out != 0).all(dim=(2, 3))
    assert torch.equal(kept, (out != 0).any(dim=(2, 3)))  # whole channels
    x3 = torch.from_numpy(_f32(rng, 2, 3, 2, 2, 2)) + 2.0
    out3 = TF.dropout3d(x3, 0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal((out3 != 0).all(dim=(2, 3, 4)),
                       (out3 != 0).any(dim=(2, 3, 4)))
    xa = torch.from_numpy(_f32(rng, 50, 40))
    p = 0.3
    outa = TF.alpha_dropout(xa, p, generator=torch.Generator().manual_seed(3))
    alpha_p = -1.6732632423543772848170429916717 * 1.0507009873554804934193349852946
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    dropped = torch.isclose(outa, torch.tensor(a * alpha_p + b))
    torch.testing.assert_close(outa[~dropped], (a * xa + b)[~dropped])
    assert 0.2 < float(dropped.float().mean()) < 0.4


def _layer_cases():
    """id -> (builder(nn module, side) -> layer, inputs builder(rng))."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    x4 = lambda r: (_f32(r, 2, 4, 6, 6),)  # noqa: E731
    return {
        "Identity": (lambda nn, s: nn.Identity(3, foo=1), x4),
        "Linear": (lambda nn, s: nn.Linear(6, 3, **kw(s)),
                   lambda r: (_f32(r, 2, 6),)),
        "Embedding": (lambda nn, s: nn.Embedding(10, 3, padding_idx=2,
                                                 **kw(s)),
                      lambda r: (np.array([[2, 5, 9]], np.int64),)),
        "Dropout_eval": (lambda nn, s: nn.Dropout(0.3, mode=(
            "downscale_in_infer")).eval(), x4),
        "Dropout2D_eval": (lambda nn, s: nn.Dropout2D(0.3).eval(), x4),
        "Dropout3D_eval": (lambda nn, s: nn.Dropout3D(0.3).eval(),
                           lambda r: (_f32(r, 1, 2, 2, 2, 2),)),
        "AlphaDropout_eval": (lambda nn, s: nn.AlphaDropout(0.3).eval(),
                              x4),
        "Flatten": (lambda nn, s: nn.Flatten(1, 2), x4),
        "Upsample": (lambda nn, s: nn.Upsample(size=[8, 9],
                                               mode="bilinear"), x4),
        "UpsamplingNearest2D": (lambda nn, s: nn.UpsamplingNearest2D(
            scale_factor=2), x4),
        "UpsamplingBilinear2D": (lambda nn, s: nn.UpsamplingBilinear2D(
            size=[4, 9]), x4),
        "Pad1D": (lambda nn, s: nn.Pad1D([1, 2], mode="replicate"),
                  lambda r: (_f32(r, 2, 3, 5),)),
        "Pad2D": (lambda nn, s: nn.Pad2D(1, mode="reflect"), x4),
        "Pad3D": (lambda nn, s: nn.Pad3D([1, 0, 0, 1, 2, 1], value=0.5),
                  lambda r: (_f32(r, 1, 2, 3, 3, 3),)),
        "ZeroPad2D": (lambda nn, s: nn.ZeroPad2D([1, 2, 3, 0]), x4),
        "CosineSimilarity": (lambda nn, s: nn.CosineSimilarity(axis=2),
                             lambda r: (_f32(r, 2, 3, 4), _f32(r, 2, 3, 4))),
        "Bilinear": (lambda nn, s: nn.Bilinear(3, 4, 5, **kw(s)),
                     lambda r: (_f32(r, 6, 3), _f32(r, 6, 4))),
        "Bilinear_no_bias": (lambda nn, s: nn.Bilinear(
            3, 4, 5, bias_attr=False, **kw(s)),
            lambda r: (_f32(r, 6, 3), _f32(r, 6, 4))),
        "Unfold": (lambda nn, s: nn.Unfold([3, 2], strides=2, paddings=1),
                   x4),
        "Fold": (lambda nn, s: nn.Fold([4, 5], [2, 2]),
                 lambda r: (_f32(r, 2, 8, 12),)),
        "PixelShuffle": (lambda nn, s: nn.PixelShuffle(2), x4),
        "PixelUnshuffle": (lambda nn, s: nn.PixelUnshuffle(3), x4),
        "ChannelShuffle": (lambda nn, s: nn.ChannelShuffle(2), x4),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layer_matches_the_reference(name):
    """The layer built in both packages, the reference's parameters (if
    any) carried over by ``load_jax_params``, the same output and, for
    float inputs, the same input gradient."""
    build, inputs = _layer_cases()[name]
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    params = {k: np.asarray(v) for k, v in jfunc.get_params(ref).items()}
    load_jax_params(port, params)
    args = inputs(np.random.RandomState(3))
    want = _value(ref(*map(_to_ref, args)))
    targs = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32)
             for a in args]
    got = port(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    floats = [t for t in targs if t.requires_grad]
    if floats:
        got.square().sum().backward()
        jargs = [paddle.to_tensor(a, stop_gradient=a.dtype != np.float32)
                 for a in args]
        ref(*jargs).square().sum().backward()
        for t, j in zip(targs, jargs):
            if t.requires_grad:
                np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(),
                                           rtol=1e-4, atol=1e-5)


def test_dropout_layers_own_a_generator_and_take_the_models():
    """A dropout layer without a generator draws from its own (seeded
    when it was made, so two layers differ and a layer repeats itself
    after a re-seed of the initializers); given one, it draws from it."""
    x = torch.ones(64, 32)
    tnn.initializer.seed(5)
    a, b = tnn.Dropout(0.5), tnn.Dropout(0.5)
    tnn.initializer.seed(5)
    a2 = tnn.Dropout(0.5)
    state = torch.get_rng_state()
    ya, yb, ya2 = a(x), b(x), a2(x)
    assert torch.equal(torch.get_rng_state(), state)
    assert not torch.equal(ya, yb) and torch.equal(ya, ya2)
    gen = torch.Generator().manual_seed(3)
    d = tnn.Dropout(0.5, generator=gen)
    y1 = d(x)
    y2 = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(3))(x)
    assert torch.equal(y1, y2)
    assert torch.equal(d.eval()(x), x)
