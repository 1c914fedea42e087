"""The port's Transformer layers (`nn.layer.transformer`) against the
reference's at a small width (d_model 32, 4 heads, d_ff 64, 2 + 2
layers), the reference's weights carried across by name (`q_proj` ...
`norm3`), f32: `MultiHeadAttention` (self and cross attention, bool and
float masks, its weights, its `Cache` / `StaticCache`), the encoder and
decoder layers and stacks (post- and pre-norm), and `Transformer` with a
[B, 1, 1, S] key-padding mask and `generate_square_subsequent_mask`.
Values and the gradients of the inputs and every parameter for one
cotangent; the incremental decode against the full causal forward; the
attention dropout by its statistics and by eval mode."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
from paddle_tpu_torch.ops import fused
from torch_parity import assert_close, port_call, ref_call
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32; the reference's LayerNorm is one-pass, the port's two-pass (the
# residual stream's |mean| is of the order of its spread), and the
# products are summed in other orders
VALUE_TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
D, NH, FF, B, S, L = 32, 4, 64, 2, 7, 5


def _kw(side):
    return {} if side == "ref" else {"device": "cpu"}


def _f32(r, *shape):
    return r.randn(*shape).astype(np.float32)


def _padding_mask(r):
    """[B, 1, 1, S] bool, True where a key is kept (row 1 keeps 4)."""
    keep = np.ones((B, 1, 1, S), bool)
    keep[1, ..., 4:] = False
    return keep


def _causal(n):
    return np.triu(np.full((n, n), -np.inf, np.float32), 1)


def _cases():
    """id -> (build(nn, side) -> layer, inputs maker(rng) -> args,
    positions of the float inputs to differentiate)."""
    enc = lambda nb: lambda nn, s: nn.TransformerEncoderLayer(  # noqa: E731
        D, NH, FF, dropout=0.0, normalize_before=nb, **_kw(s))
    dec = lambda nb: lambda nn, s: nn.TransformerDecoderLayer(  # noqa: E731
        D, NH, FF, dropout=0.0, normalize_before=nb, **_kw(s))
    return {
        "mha_self": (lambda nn, s: nn.MultiHeadAttention(D, NH, **_kw(s)),
                     lambda r: (_f32(r, B, L, D),), (0,)),
        "mha_cross_kdim_vdim_bool_mask": (
            lambda nn, s: nn.MultiHeadAttention(D, NH, kdim=12, vdim=8,
                                                **_kw(s)),
            lambda r: (_f32(r, B, L, D), _f32(r, B, S, 12),
                       _f32(r, B, S, 8), _padding_mask(r)), (0, 1, 2)),
        "mha_float_mask_weights": (
            lambda nn, s: nn.MultiHeadAttention(D, NH, need_weights=True,
                                                **_kw(s)),
            lambda r: (_f32(r, B, L, D), None, None, _causal(L)), (0,)),
        "encoder_layer_post_norm": (enc(False), lambda r: (
            _f32(r, B, S, D), _padding_mask(r)), (0,)),
        "encoder_layer_pre_norm_gelu": (
            lambda nn, s: nn.TransformerEncoderLayer(
                D, NH, FF, dropout=0.0, activation="gelu",
                normalize_before=True, **_kw(s)),
            lambda r: (_f32(r, B, S, D),), (0,)),
        "encoder_stack_with_norm": (
            lambda nn, s: nn.TransformerEncoder(enc(True)(nn, s), 2,
                                                nn.LayerNorm(D, **_kw(s))),
            lambda r: (_f32(r, B, S, D), _padding_mask(r)), (0,)),
        "decoder_layer": (dec(False), lambda r: (
            _f32(r, B, L, D), _f32(r, B, S, D), _causal(L),
            _padding_mask(r)), (0, 1)),
        "decoder_stack_pre_norm": (
            lambda nn, s: nn.TransformerDecoder(dec(True)(nn, s), 2),
            lambda r: (_f32(r, B, L, D), _f32(r, B, S, D), _causal(L)),
            (0, 1)),
        "transformer": (
            lambda nn, s: nn.Transformer(D, NH, 2, 2, FF, dropout=0.0,
                                         **_kw(s)),
            lambda r: (_f32(r, B, S, D), _f32(r, B, L, D),
                       _padding_mask(r), _causal(L), _padding_mask(r)),
            (0, 1)),
        "transformer_pre_norm": (
            lambda nn, s: nn.Transformer(D, NH, 2, 2, FF, dropout=0.0,
                                         normalize_before=True, **_kw(s)),
            lambda r: (_f32(r, B, S, D), _f32(r, B, L, D), None,
                       _causal(L)), (0, 1)),
    }


CASES = _cases()


def _pair(build):
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in jfunc.get_params(ref).items()})
    return ref, port


def _param_grads(port, ref):
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    want = {k: np.asarray(p.grad.numpy())
            for k, p in ref.named_parameters()}
    assert sorted(got) == sorted(want)
    return [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]


def _flat(out, cat):
    if isinstance(out, tuple):
        return cat([o.reshape([-1]) for o in out])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_the_reference(name):
    build, inputs, grad = CASES[name]
    ref, port = _pair(build)
    args = list(inputs(np.random.RandomState(0)))
    got = port_call(lambda *a: _flat(port(*a), torch.cat), args, grad=grad)
    want = ref_call(lambda *a: _flat(ref(*a), paddle.concat), args,
                    grad=grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert_close(*_param_grads(port, ref), what=name, **GRAD_TOL)


def test_parameter_names_are_the_references():
    ref, port = _pair(CASES["transformer"][0])
    names = {k for k, _ in port.named_parameters()}
    assert names == set(jfunc.get_params(ref))
    for k in ("encoder.layers.1.self_attn.q_proj.weight",
              "decoder.layers.0.cross_attn.out_proj.bias",
              "decoder.layers.1.norm3.weight", "encoder.layers.0.linear2.weight"):
        assert k in names


def test_square_subsequent_mask_is_the_references():
    ref, port = _pair(CASES["transformer"][0])
    got = port.generate_square_subsequent_mask(6)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), ref.generate_square_subsequent_mask(6).numpy())


def _decode_stepwise(decoder, tgt, memory, mask=None):
    """The decoder's outputs one position at a time through its caches
    (``gen_cache``: a Cache per self-attention, a StaticCache per
    cross-attention)."""
    cache = decoder.gen_cache(memory)
    outs = []
    for t in range(tgt.shape[1]):
        out, cache = decoder(tgt[:, t:t + 1], memory, None, mask, cache)
        outs.append(out)
    return outs, cache


def test_incremental_decode_equals_the_full_causal_forward():
    """Position t of the cached decode equals position t of the full
    forward under the causal mask; the caches grow by one position a step
    and start empty on the memory's device and dtype."""
    _, dec = _pair(CASES["decoder_stack_pre_norm"][0])
    r = np.random.RandomState(1)
    tgt, mem = (torch.from_numpy(_f32(r, B, L, D)),
                torch.from_numpy(_f32(r, B, S, D)))
    with torch.no_grad():
        full = dec(tgt, mem, torch.from_numpy(_causal(L)))
        outs, cache = _decode_stepwise(dec, tgt, mem)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-5,
                               atol=2e-5)
    assert tuple(cache[0][0].k.shape) == (B, NH, L, D // NH)
    assert tuple(cache[0][1].k.shape) == (B, NH, S, D // NH)
    empty = dec.gen_cache(mem)[0][0]
    assert tuple(empty.k.shape) == (B, NH, 0, D // NH)
    assert empty.k.device == mem.device and empty.k.dtype == mem.dtype


def test_self_attention_cache_steps_match_the_reference():
    """``MultiHeadAttention`` with a ``Cache``, one query a step, in both
    packages: the same outputs and the same cached keys and values."""
    ref, port = _pair(CASES["mha_self"][0])
    x = _f32(np.random.RandomState(2), B, L, D)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    jc = ref.gen_cache(jx, type=paddle.nn.MultiHeadAttention.Cache)
    tc = port.gen_cache(tx, type=tnn.MultiHeadAttention.Cache)
    for t in range(L):
        jo, jc = ref(jx[:, t:t + 1], cache=jc)
        to, tc = port(tx[:, t:t + 1], cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   **VALUE_TOL)
    np.testing.assert_allclose(tc.v.detach().numpy(), jc.v.numpy(),
                               **VALUE_TOL)


def test_static_cache_is_used_as_given():
    """A ``StaticCache`` holds keys and values already split into heads;
    the port attends to them as they are, and gives the cross attention's
    output. The reference splits them into heads a second time, which
    fails unless the memory's length equals the number of heads
    (ROADMAP, Queue 3: not copied)."""
    ref, port = _pair(CASES["mha_self"][0])
    r = np.random.RandomState(3)
    q, mem = _f32(r, B, L, D), _f32(r, B, S, D)
    tq, tm = torch.from_numpy(q), torch.from_numpy(mem)
    static = port.gen_cache(tm, tm, type=tnn.MultiHeadAttention.StaticCache)
    out, kept = port(tq, tm, tm, cache=static)
    torch.testing.assert_close(out, port(tq, tm, tm), rtol=1e-6, atol=1e-6)
    assert kept is static
    jm = paddle.to_tensor(mem)
    jstatic = ref.gen_cache(jm, jm,
                            type=paddle.nn.MultiHeadAttention.StaticCache)
    with pytest.raises(TypeError, match="reshape"):
        ref(paddle.to_tensor(q), jm, jm, cache=jstatic)


def test_gen_cache_zips_and_mha_returns_its_cache():
    _, port = _pair(CASES["decoder_stack_pre_norm"][0])
    mem = torch.randn(B, S, D)
    zipped = port.gen_cache(mem, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert isinstance(zipped[0][0], tnn.MultiHeadAttention.Cache)
    assert isinstance(zipped[1][0], tnn.MultiHeadAttention.StaticCache)
    mha = port.layers[0].self_attn
    out, cache = mha(mem[:, :1], cache=mha.gen_cache(mem))
    assert cache.k.shape[2] == 1 and out.shape == (B, 1, D)


def test_layer_norms_are_the_kernels_path(monkeypatch):
    """Every LayerNorm of the residual stream goes through
    ``fused_layer_norm`` (#5 / #6 on the card): 2 per encoder layer and 3
    per decoder layer."""
    from paddle_tpu_torch.nn.layer import norm as norm_mod

    calls = []
    real = norm_mod.fused_layer_norm
    monkeypatch.setattr(norm_mod, "fused_layer_norm",
                        lambda *a: calls.append(a) or real(*a))
    model = tnn.Transformer(D, NH, 2, 2, FF, dropout=0.0, device="cpu")
    model(torch.randn(B, S, D), torch.randn(B, L, D))
    assert len(calls) == 2 * 2 + 2 * 3
    assert fused.fused_layer_norm is not None


def test_attention_dropout_statistics_and_eval_mode():
    """Dropout on the attention weights (then the second product again):
    the same generator state gives the same output, about p of the
    weights drop, torch's global RNG is untouched, and eval mode gives the
    undropped attention."""
    gen = torch.Generator().manual_seed(0)
    mha = tnn.MultiHeadAttention(D, NH, dropout=0.4, need_weights=True,
                                 device="cpu", generator=gen)
    x = torch.randn(4, 16, D, generator=torch.Generator().manual_seed(1))
    state = torch.get_rng_state()
    gen.manual_seed(5)
    a, wa = mha(x)
    gen.manual_seed(5)
    b, _ = mha(x)
    assert torch.equal(torch.get_rng_state(), state) and torch.equal(a, b)
    assert 0.3 < float((wa == 0).float().mean()) < 0.5
    mha.eval()
    c, wc = mha(x)
    torch.testing.assert_close(wc.sum(-1), torch.ones_like(wc.sum(-1)))
    mha.dropout = 0.0
    torch.testing.assert_close(mha(x)[0], c)


def test_stack_copies_share_the_callers_generator():
    """The encoder's deep copies draw from the generator the caller gave
    (not a copy of it), as one model-owned stream."""
    gen = torch.Generator().manual_seed(0)
    layer = tnn.TransformerEncoderLayer(D, NH, FF, dropout=0.1,
                                        device="cpu", generator=gen)
    enc = tnn.TransformerEncoder(layer, 3)
    gens = {m.generator for m in enc.modules()
            if isinstance(m, tnn.Dropout)}
    assert gens == {gen}
    own = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        D, NH, FF, dropout=0.1, device="cpu"), 2)
    seeds = [m._seed for m in own.modules() if isinstance(m, tnn.Dropout)]
    assert len(set(seeds)) == len(seeds)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_on_the_card_matches_the_cpu(name):
    torch.backends.cuda.matmul.allow_tf32 = False
    build, inputs, grad = CASES[name]
    cpu = build(tnn, "port")
    card = build(tnn, "port").cuda()
    card.load_state_dict(cpu.state_dict())
    args = list(inputs(np.random.RandomState(0)))
    got = port_call(lambda *a: _flat(card(*a), torch.cat), args, grad=grad,
                    device="cuda")
    want = port_call(lambda *a: _flat(cpu(*a), torch.cat), args, grad=grad)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
