"""The port's recurrent layers (`nn.layer.rnn`) against the reference's on
the same seeded numpy inputs and the reference's weights carried across
by name (`weight_ih_l0`, `weight_hh_l1_reverse`, ...), f32: `LSTM`, `GRU`
and `SimpleRNN` at one and two layers, one and two directions, batch- or
time-major, with and without initial states; the cells and the `RNN` /
`BiRNN` wrappers. Values of the outputs and final states together, and
the gradients of the input and of every parameter for one cotangent. The
inter-layer dropout draws from a `torch.Generator` (the reference from
its key), so it is held by its statistics and by eval mode; a
`sequence_length` is refused."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
from torch_parity import assert_close, port_call, ref_call
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32 over 5 steps: the products are summed in other orders
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, T, IN, H = 3, 5, 4, 6


def _flat(outs, cat):
    """The outputs and final states as one flat vector."""
    flat = []

    def walk(o):
        if isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        else:
            flat.append(o.reshape([-1]))

    walk(outs)
    return cat(flat)


def _networks():
    """id -> (build(nn, side) -> layer, input shape, with initial
    states)."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    cases = {}
    for cls in ("LSTM", "GRU", "SimpleRNN"):
        for nl in (1, 2):
            for direction in ("forward", "bidirect"):
                cases[f"{cls}_l{nl}_{direction}"] = (
                    lambda nn, s, c=cls, n=nl, d=direction: getattr(nn, c)(
                        IN, H, num_layers=n, direction=d, **kw(s)),
                    (B, T, IN), False)
    cases["LSTM_time_major_initial_states"] = (
        lambda nn, s: nn.LSTM(IN, H, num_layers=2, time_major=True,
                              **kw(s)), (T, B, IN), True)
    cases["GRU_bidirect_initial_states"] = (
        lambda nn, s: nn.GRU(IN, H, direction="bidirectional", **kw(s)),
        (B, T, IN), True)
    cases["SimpleRNN_relu"] = (
        lambda nn, s: nn.SimpleRNN(IN, H, activation="relu", **kw(s)),
        (B, T, IN), True)
    return cases


NETWORKS = _networks()


def _initial_states(layer, r):
    n = layer.num_layers * layer.num_directions
    h0 = r.randn(n, B, H).astype(np.float32)
    if type(layer).__name__ == "LSTM":
        return (h0, r.randn(n, B, H).astype(np.float32))
    return h0


def _param_grads(port, ref):
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    want = {k: np.asarray(p.grad.numpy())
            for k, p in ref.named_parameters()}
    assert sorted(got) == sorted(want)
    return [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]


def _conv(states, to):
    if states is None:
        return None
    if isinstance(states, tuple):
        return tuple(to(s) for s in states)
    return to(states)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_the_reference(name):
    build, shape, with_states = NETWORKS[name]
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in jfunc.get_params(ref).items()})
    r = np.random.RandomState(0)
    x = r.randn(*shape).astype(np.float32)
    init = _initial_states(ref, r) if with_states else None
    got = port_call(lambda a: _flat(port(a, _conv(init, torch.from_numpy)),
                                    torch.cat), [x], grad=(0,))
    want = ref_call(lambda a: _flat(ref(a, _conv(init, paddle.to_tensor)),
                                    paddle.concat), [x], grad=(0,))
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert_close(*_param_grads(port, ref), what=name, **GRAD_TOL)


def _cells():
    """id -> (build(nn, side) -> layer, inputs maker(rng), runs over
    time)."""
    def kw(s):
        return {} if s == "ref" else {"device": "cpu"}

    step = lambda r: (r.randn(B, IN).astype(np.float32),)  # noqa: E731
    seq = lambda r: (r.randn(B, T, IN).astype(np.float32),)  # noqa: E731
    return {
        "SimpleRNNCell": (lambda nn, s: nn.SimpleRNNCell(IN, H, **kw(s)),
                          step),
        "SimpleRNNCell_relu": (lambda nn, s: nn.SimpleRNNCell(
            IN, H, activation="relu", **kw(s)), step),
        "LSTMCell": (lambda nn, s: nn.LSTMCell(IN, H, **kw(s)), step),
        "GRUCell": (lambda nn, s: nn.GRUCell(IN, H, **kw(s)), step),
        "RNN_LSTMCell": (lambda nn, s: nn.RNN(nn.LSTMCell(IN, H, **kw(s))),
                         seq),
        "RNN_GRUCell_reverse": (lambda nn, s: nn.RNN(
            nn.GRUCell(IN, H, **kw(s)), is_reverse=True), seq),
        "BiRNN": (lambda nn, s: nn.BiRNN(nn.LSTMCell(IN, H, **kw(s)),
                                         nn.GRUCell(IN, H, **kw(s))), seq),
    }


@pytest.mark.parametrize("name", sorted(_cells()))
def test_cell_and_wrapper_match_the_reference(name):
    build, inputs = _cells()[name]
    ref, port = build(paddle.nn, "ref"), build(tnn, "port")
    load_jax_params(port, {k: np.asarray(v)
                           for k, v in jfunc.get_params(ref).items()})
    args = inputs(np.random.RandomState(1))
    got = port_call(lambda a: _flat(port(a), torch.cat), args, grad=(0,))
    want = ref_call(lambda a: _flat(ref(a), paddle.concat), args,
                    grad=(0,))
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
    assert_close(*_param_grads(port, ref), what=name, **GRAD_TOL)


@pytest.mark.parametrize("make", [
    lambda: tnn.LSTM(IN, H, device="cpu"),
    lambda: tnn.RNN(tnn.GRUCell(IN, H, device="cpu")),
    lambda: tnn.BiRNN(tnn.GRUCell(IN, H, device="cpu"),
                      tnn.GRUCell(IN, H, device="cpu"))])
def test_sequence_length_is_refused(make):
    """The reference takes ``sequence_length`` and ignores it; the port
    refuses it rather than run past each sequence's end."""
    x = torch.zeros(B, T, IN)
    with pytest.raises(NotImplementedError, match="sequence_length"):
        make()(x, sequence_length=torch.tensor([5, 3, 2]))


def test_inter_layer_dropout_draws_from_its_generator():
    """p = 0.5 between two layers: the same generator state gives the
    same output, about half of the first layer's units are dropped (one
    mask a sequence, kept over time), torch's global RNG is untouched, and
    eval mode gives the undropped network."""
    lstm = tnn.LSTM(IN, 64, num_layers=2, dropout=0.5, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    plain = tnn.LSTM(IN, 64, num_layers=2, device="cpu")
    plain.load_state_dict(lstm.state_dict())
    x = torch.randn(8, T, IN, generator=torch.Generator().manual_seed(4))
    state = torch.get_rng_state()
    lstm.generator.manual_seed(7)
    a = lstm(x)[0]
    lstm.generator.manual_seed(7)
    b = lstm(x)[0]
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(a, b)
    assert not torch.allclose(a, plain(x)[0])
    lstm.eval()
    assert torch.equal(lstm(x)[0], plain(x)[0])

    seen = []
    lstm.train()
    orig = lstm._run
    lstm._run = lambda xx, *rest: (seen.append(xx), orig(xx, *rest))[1]
    lstm(x)
    layer2_in = seen[1]  # [T, B, 64]: the first layer's dropped output
    dropped = layer2_in == 0
    assert torch.equal(dropped.all(0), dropped.any(0))  # kept over time
    assert 0.35 < float(dropped[0].float().mean()) < 0.65


def test_weights_are_uniform_in_one_over_root_h():
    lstm = tnn.LSTM(IN, 16, num_layers=2, direction="bidirect",
                    device="cpu")
    names = [k for k, _ in lstm.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert "weight_ih_l1_reverse" in names
    assert lstm.weight_ih_l1.shape == (64, 32)
    for p in lstm.parameters():
        assert float(p.abs().max()) <= 0.25


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_on_the_card_matches_the_cpu(name):
    torch.backends.cuda.matmul.allow_tf32 = False
    build, shape, with_states = NETWORKS[name]
    cpu = build(tnn, "port")
    card = build(tnn, "port").cuda()
    card.load_state_dict(cpu.state_dict())
    r = np.random.RandomState(0)
    x = r.randn(*shape).astype(np.float32)
    init = _initial_states(cpu, r) if with_states else None
    got = port_call(lambda a: _flat(card(a, _conv(
        init, lambda s: torch.from_numpy(s).cuda())), torch.cat), [x],
        grad=(0,), device="cuda")
    want = port_call(lambda a: _flat(cpu(a, _conv(init, torch.from_numpy)),
                                     torch.cat), [x], grad=(0,))
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name, **GRAD_TOL)
