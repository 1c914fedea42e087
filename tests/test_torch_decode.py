"""The port's beam search (`nn.layer.decode`) against the reference's:
`gather_tree`, the one-step `beam_search` and `beam_search_decode` (the
cases of tests/test_seq2seq_ops.py and random ones), `BeamSearchDecoder`
through `dynamic_decode` over a table cell and a GRU cell with an
embedding and an output layer (weights carried across), the same ids,
scores and lengths; `dynamic_decode`'s latch of a decoder's per-step
flags. Then the port alone: beam search over a small `TransformerDecoder`
through its `gen_cache` caches, where each step's incremental logits equal
the full causal forward's, each beam's score is the sum of the full
forward's log-probabilities of its tokens, the beams come sorted, and
beam size 1 is the greedy decode."""
import importlib
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit.functionalize import load_jax_params
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32 scores: log-softmax sums, taken in other orders
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def np_gather_tree(ids, parents):
    T, B, K = ids.shape
    out = np.zeros_like(ids)
    for b in range(B):
        for k in range(K):
            beam = k
            for t in range(T - 1, -1, -1):
                out[t, b, k] = ids[t, b, beam]
                beam = parents[t, b, beam]
    return out


def test_gather_tree_matches_the_reference_and_numpy():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (5, 3, 4)).astype(np.int64)
    parents = rng.randint(0, 4, (5, 3, 4)).astype(np.int64)
    got = tnn.functional.gather_tree(torch.from_numpy(ids),
                                     torch.from_numpy(parents)).numpy()
    want = jnn.gather_tree(paddle.to_tensor(ids),
                           paddle.to_tensor(parents)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_gather_tree(ids, parents))


def _beam_search_cases():
    """id -> (pre_ids, pre_scores, ids, scores, kwargs)."""
    r = np.random.RandomState(1)
    return {
        "one_step_topk": (np.array([[5, 7]], np.int64),
                          np.array([[0.0, -0.1]], np.float32), None,
                          np.array([[[0.5, 0.4, 0.1], [0.45, 0.2, 0.3]]],
                                   np.float32), dict(beam_size=2, end_id=0)),
        "ended_beam_frozen": (np.array([[9, 3]], np.int64),
                              np.array([[2.0, 0.0]], np.float32), None,
                              np.array([[[1.5, 1.4], [0.6, 0.2]]],
                                       np.float32),
                              dict(beam_size=2, end_id=9)),
        "random_probabilities_with_ids": (
            np.array([[1, 4, 2], [9, 3, 9]], np.int64),
            r.randn(2, 3).astype(np.float32),
            r.randint(0, 20, (2, 3, 5)).astype(np.int64),
            r.rand(2, 3, 5).astype(np.float32),
            dict(beam_size=3, end_id=9, is_accumulated=False)),
    }


@pytest.mark.parametrize("name", sorted(_beam_search_cases()))
def test_beam_search_step_matches_the_reference(name):
    pre_ids, pre_scores, ids, scores, kw = _beam_search_cases()[name]
    to_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa
    to_j = lambda a: None if a is None else paddle.to_tensor(a)  # noqa
    got = tnn.beam_search(to_t(pre_ids), to_t(pre_scores), to_t(ids),
                          to_t(scores), return_parent_idx=True, **kw)
    want = jnn.beam_search(to_j(pre_ids), to_j(pre_scores), to_j(ids),
                           to_j(scores), return_parent_idx=True, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), **SCORE_TOL)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    two = tnn.beam_search(to_t(pre_ids), to_t(pre_scores), to_t(ids),
                          to_t(scores), **kw)
    assert len(two) == 2


@pytest.mark.parametrize("with_parents", [False, True])
def test_beam_search_decode_matches_the_reference(with_parents):
    r = np.random.RandomState(2)
    ids = r.randint(0, 9, (4, 2, 3)).astype(np.int64)
    scores = r.randn(4, 2, 3).astype(np.float32)
    parents = r.randint(0, 3, (4, 2, 3)).astype(np.int64)
    kw = dict(parent_ids=parents) if with_parents else {}
    got = tnn.beam_search_decode(
        torch.from_numpy(ids), torch.from_numpy(scores), 3, 8,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    want = jnn.beam_search_decode(
        paddle.to_tensor(ids), paddle.to_tensor(scores), 3, 8,
        **{k: paddle.to_tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


V, H, B, K = 12, 16, 2, 3


class _TableCell:
    """Logits that depend only on the input token (one-hot rows select
    rows of a fixed table), so the decode is independently computable."""

    def __init__(self, table, matmul):
        self.table, self.matmul = table, matmul

    def __call__(self, inputs, states):
        return self.matmul(inputs, self.table), states


def _table_decoders(r):
    table = (r.randn(V, V) * 3).astype(np.float32)
    eye = np.eye(V, dtype=np.float32)
    ref = jnn.BeamSearchDecoder(
        _TableCell(paddle.to_tensor(table), paddle.matmul), 0, V - 1, K,
        embedding_fn=lambda i: paddle.to_tensor(eye)[i])
    port = tnn.BeamSearchDecoder(
        _TableCell(torch.from_numpy(table), torch.matmul), 0, V - 1, K,
        embedding_fn=lambda i: torch.from_numpy(eye)[i])
    init = np.zeros((B, 1), np.float32)
    return ref, port, init


def _gru_decoders(r):
    ref_parts = (jnn.GRUCell(H, H), jnn.Embedding(V, H), jnn.Linear(H, V))
    port_parts = (tnn.GRUCell(H, H, device="cpu"),
                  tnn.Embedding(V, H, device="cpu"),
                  tnn.Linear(H, V, device="cpu"))
    for j, t in zip(ref_parts, port_parts):
        load_jax_params(t, {k: np.asarray(v)
                            for k, v in jfunc.get_params(j).items()})
    ref = jnn.BeamSearchDecoder(ref_parts[0], 1, 2, K,
                                embedding_fn=ref_parts[1],
                                output_fn=ref_parts[2])
    port = tnn.BeamSearchDecoder(port_parts[0], 1, 2, K,
                                 embedding_fn=port_parts[1],
                                 output_fn=port_parts[2])
    return ref, port, r.randn(B, H).astype(np.float32)


@pytest.mark.parametrize("make", [_table_decoders, _gru_decoders],
                         ids=["table_cell", "gru_cell"])
@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_matches_the_reference(make, time_major):
    ref, port, init = make(np.random.RandomState(3))
    j_ids, j_states, j_len = jnn.dynamic_decode(
        ref, inits=paddle.to_tensor(init), max_step_num=8,
        output_time_major=time_major, return_length=True)
    with torch.no_grad():
        t_ids, t_states, t_len = tnn.dynamic_decode(
            port, inits=torch.from_numpy(init), max_step_num=8,
            output_time_major=time_major, return_length=True)
    np.testing.assert_array_equal(t_ids.numpy(), j_ids.numpy())
    np.testing.assert_array_equal(t_len.numpy(), j_len.numpy())
    np.testing.assert_allclose(t_states.log_probs.numpy(),
                               j_states.log_probs.numpy(), **SCORE_TOL)
    np.testing.assert_array_equal(t_states.finished.numpy(),
                                  j_states.finished.numpy())


def test_step_flags_of_a_plain_decoder_latch():
    """A decoder that tracks no finished state of its own: its per-step
    flags are OR-ed in, so a sequence cannot un-finish (the loop ends
    when both have finished, after 4 steps), as in the reference."""
    class Flicker:
        tracks_own_finished = False

        def initialize(self, inits):
            return (torch.zeros(2, 1), {"t": 0},
                    torch.tensor([False, False]))

        def step(self, time, inputs, states, **kw):
            t = int(time[0])
            out = torch.full((2, 1), float(t))
            return out, {"t": t}, inputs, torch.tensor([t == 1, t >= 3])

    outs, states = tnn.dynamic_decode(Flicker(), max_step_num=10)
    assert tuple(outs.shape) == (2, 4, 1) and states == {"t": 3}


# -- the port alone: beam search over a Transformer decoder's caches -----------
D, NH, FF, S, VT, END = 32, 4, 64, 6, 16, 1


def _sinusoid(n, d):
    pos = np.arange(n)[:, None] / np.power(10000.0, np.arange(0, d, 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2], table[:, 1::2] = np.sin(pos), np.cos(pos)
    return torch.from_numpy(table)


class _Seq2Seq(torch.nn.Module):
    """A Transformer with a shared, tied embedding (scaled by √d) and
    sinusoidal positions: ``logits(src, tgt_ids)`` is the full causal
    forward; ``cell`` is the beam-search cell over the decoder's
    caches."""

    def __init__(self):
        super().__init__()
        self.model = tnn.Transformer(D, NH, 2, 2, FF, dropout=0.0,
                                     device="cpu")
        self.emb = tnn.Embedding(VT, D, device="cpu")
        self.register_buffer("pos", _sinusoid(64, D))

    def embed(self, ids, start=0):
        x = self.emb(ids) * math.sqrt(D)
        return x + self.pos[start:start + ids.shape[1]]

    def encode(self, src):
        return self.model.encoder(self.embed(src))

    def logits(self, memory, tgt):
        mask = self.model.generate_square_subsequent_mask(tgt.shape[1])
        out = self.model.decoder(self.embed(tgt), memory, mask)
        return out @ self.emb.weight.t()

    def cell(self, inputs, states, memory=None, check=None):
        caches, seen = states["caches"], states["tokens"]
        t = seen.shape[1]
        x = self.embed(inputs[:, None], start=t)
        out, caches = self.model.decoder(x, memory, None, None, caches)
        logits = (out @ self.emb.weight.t())[:, 0]
        tokens = torch.cat([seen, inputs[:, None]], 1)
        if check is not None:
            full = self.logits(memory, tokens)[:, -1]
            check.append(float((full - logits).abs().max()))
        return logits, {"caches": caches, "tokens": tokens}


def _beam_decode(net, src, beam, steps, check=None):
    memory = net.encode(src)
    tiled = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(memory, beam)
    init = {"caches": net.model.decoder.gen_cache(memory),
            "tokens": torch.zeros(src.shape[0], 0, dtype=torch.int64)}
    dec = tnn.BeamSearchDecoder(net.cell, 0, END, beam)
    return tnn.dynamic_decode(dec, inits=init, max_step_num=steps,
                              return_length=True, memory=tiled, check=check)


def _sequence_log_prob(net, memory, tokens):
    """Σ log p(token_t | prefix) under the full forward, up to and
    including the first end token."""
    ids = torch.cat([torch.zeros(1, 1, dtype=torch.int64), tokens[None]], 1)
    logp = torch.log_softmax(net.logits(memory, ids[:, :-1]), -1)[0]
    total = 0.0
    for t, tok in enumerate(tokens.tolist()):
        total += float(logp[t, tok])
        if tok == END:
            break
    return total


@pytest.fixture(scope="module")
def seq2seq():
    tnn.initializer.seed(11)
    net = _Seq2Seq().eval()
    src = torch.randint(2, VT, (2, S), generator=torch.Generator()
                        .manual_seed(0))
    return net, src


def test_transformer_beam_search_scores_are_the_full_forwards(seq2seq):
    net, src = seq2seq
    check = []
    with torch.no_grad():
        ids, states, lengths = _beam_decode(net, src, 4, 8, check)
        memory = net.encode(src)
        assert max(check) < 1e-4  # incremental vs full logits, each step
        scores = states.log_probs
        assert torch.all(scores[:, :-1] >= scores[:, 1:])  # sorted
        for b in range(src.shape[0]):
            for k in range(4):
                want = _sequence_log_prob(net, memory[b:b + 1], ids[b, k])
                assert abs(float(scores[b, k]) - want) < 1e-4, (b, k)
    assert ids.shape[:2] == (2, 4) and lengths.shape == (2, 4)


def test_transformer_beam_size_one_is_greedy(seq2seq):
    net, src = seq2seq
    with torch.no_grad():
        ids, _, _ = _beam_decode(net, src, 1, 8)
        memory = net.encode(src)
        for b in range(src.shape[0]):
            seq = torch.zeros(1, 1, dtype=torch.int64)
            for _ in range(ids.shape[2]):
                nxt = net.logits(memory[b:b + 1], seq)[0, -1].argmax()
                seq = torch.cat([seq, nxt.view(1, 1)], 1)
                if int(nxt) == END:
                    break
            got = ids[b, 0, :seq.shape[1] - 1]
            assert torch.equal(got, seq[0, 1:]), (got, seq)


def test_beam_step_gathers_each_state_leaf_by_its_parent_beam():
    """Every [batch, beam, ...] leaf of the cell's state (a namedtuple in
    a dict here) is reordered by the chosen parent beams; a finished beam
    proposes only the end token, at no cost."""
    dec = tnn.BeamSearchDecoder(None, 0, END, 2)
    state = dec.StateWrapper(None, torch.tensor([[0.0, -1.0]]),
                             torch.tensor([[False, True]]),
                             torch.zeros(1, 2, dtype=torch.int64))
    logits = torch.full((1, 2, 5), -5.0)
    logits[0, 0, 3] = 5.0  # beam 0 prefers token 3 strongly
    cache = tnn.MultiHeadAttention.Cache(torch.arange(10.0).reshape(1, 2, 5),
                                         torch.zeros(1, 2, 1))
    out, st = dec._beam_search_step(0, logits, {"c": cache}, state)
    # beam 0 extends with token 3; finished beam 1 keeps -1.0 with END
    assert out.predicted_ids.tolist() == [[3, END]]
    assert out.parent_ids.tolist() == [[0, 1]]
    assert st.finished.tolist() == [[False, True]]
    assert isinstance(st.cell_states["c"], tnn.MultiHeadAttention.Cache)
    assert torch.equal(st.cell_states["c"].k, cache.k[:, [0, 1]])
