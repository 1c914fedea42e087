"""The port's linear-chain CRF (`paddle_tpu_torch.text.crf`),
`text.viterbi_decode`, `text.FakeTextDataset` and `static.nn.crf_decoding`
against the reference's on the same seeded numpy inputs, on the CPU:

- `linear_chain_crf`'s cost and its gradients in the emissions and the
  transition (f32, padded lengths down to 1, no lengths, one sequence);
  the cost against a brute-force partition function;
- `crf_decoding`'s paths and 0/1 label masks, the same integers as the
  reference's (padded steps included), and the decoded path is the one of
  least cost; `viterbi_decode`'s scores and paths (all T steps: it
  ignores `lengths`, as the reference does);
- the dtypes: both packages compute in their inputs' dtype (a bf16
  training step casts the transition and gives bf16 emissions), and the
  tagger casts both to f32 before the recursion;
- a `bert_tiny` tagger (BertModel, Linear(H, 7), a [9, 7] transition) with
  the reference's weights: the CRF loss, every gradient and two AdamW
  steps of `ParallelTrainStep` against the reference's engine.
"""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.text as jtext
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.text import crf as jcrf
from paddle_tpu.text.models import bert as jbert
import paddle_tpu_torch.text as ttext
from paddle_tpu_torch import static
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.nn.layer.common import Linear
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text import crf as tcrf
from paddle_tpu_torch.text.models import bert as tbert
from torch_parity import assert_close, port_call, ref_jit_call
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

TAGS, LR, WD, STEPS = 7, 1e-3, 0.01, 2

# f32 log-space sums in the same order; the gradients through autograd
# of a loop against jax's of a scan
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the tagger: bert_tiny's encoder in f32 (the BERT tests' 1e-4 on logits),
# then 16 steps of the recursion
TAGGER_LOSS_TOL = 1e-4
TAGGER_GRAD_TOL = dict(rtol=1e-3, atol=2e-5)
# Adam moves a parameter by ~lr whatever its gradient's size, so a
# gradient component near 0 that differs by the tolerance above moves
# differently: a tenth of lr over the two steps
TAGGER_PARAM_TOL = LR / 10


def _crf_inputs(r, b=4, s=6, d=5, lengths=(6, 3, 1, 5)):
    em = r.randn(b, s, d).astype(np.float32)
    lbl = r.randint(0, d, (b, s)).astype(np.int64)
    trans = (0.5 * r.randn(d + 2, d)).astype(np.float32)
    ln = None if lengths is None else np.array(lengths, np.int64)
    return em, lbl, trans, ln


CRF_CASES = {
    "padded": {},
    "no_lengths": dict(lengths=None),
    "one_step": dict(s=1, lengths=(1, 1, 1, 1)),
    "long": dict(b=3, s=17, d=7, lengths=(17, 9, 2)),
}


def _crf(mod):
    return lambda em, lbl, trans, ln=None: mod.linear_chain_crf(
        em, lbl, trans, length=ln)


@pytest.mark.parametrize("name", sorted(CRF_CASES))
def test_linear_chain_crf_matches_the_reference(name):
    em, lbl, trans, ln = _crf_inputs(np.random.RandomState(0),
                                     **CRF_CASES[name])
    args = [em, lbl, trans] + ([] if ln is None else [ln])
    want = ref_jit_call(_crf(jcrf), args, {}, (0, 2))
    got = port_call(_crf(tcrf), args, {}, (0, 2))
    assert got[0].shape == (em.shape[0], 1)
    assert_close([got[0]], [want[0]], what=name, **VALUE_TOL)
    assert_close(got[1], want[1], what=name + " grads", **GRAD_TOL)


def _path_score(em, lbl, trans, n):
    a, b, w = trans[0], trans[1], trans[2:]
    s = a[lbl[0]] + em[0, lbl[0]] + b[lbl[n - 1]]
    for t in range(1, n):
        s += w[lbl[t - 1], lbl[t]] + em[t, lbl[t]]
    return s


def test_cost_is_the_brute_force_partition():
    em, lbl, trans, ln = _crf_inputs(np.random.RandomState(1), b=3, s=4,
                                     d=3, lengths=(4, 2, 3))
    em64, trans64 = em.astype(np.float64), trans.astype(np.float64)
    got = tcrf.linear_chain_crf(torch.from_numpy(em64), torch.from_numpy(lbl),
                                torch.from_numpy(trans64),
                                torch.from_numpy(ln)).numpy()[:, 0]
    for i, n in enumerate(ln):
        scores = [_path_score(em64[i], p, trans64, n)
                  for p in itertools.product(range(3), repeat=int(n))]
        want = np.logaddexp.reduce(scores) - _path_score(em64[i], lbl[i],
                                                         trans64, n)
        np.testing.assert_allclose(got[i], want, rtol=1e-10)


@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_same_paths_as_the_reference(with_label):
    em, lbl, trans, ln = _crf_inputs(np.random.RandomState(2), b=5, s=9,
                                     d=4, lengths=(9, 4, 1, 7, 2))
    kw = dict(label=lbl) if with_label else {}
    want = jax.jit(lambda e, t: jcrf.crf_decoding(
        e, t, length=jnp.asarray(ln),
        **{k: jnp.asarray(v) for k, v in kw.items()})._value)(em, trans)
    got = tcrf.crf_decoding(torch.from_numpy(em), torch.from_numpy(trans),
                            length=torch.from_numpy(ln),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decoded_path_has_the_least_cost():
    em, _, trans, ln = _crf_inputs(np.random.RandomState(3), b=3, s=5, d=3,
                                   lengths=(5, 3, 4))
    path = tcrf.crf_decoding(torch.from_numpy(em), torch.from_numpy(trans),
                             length=torch.from_numpy(ln))
    cost = tcrf.linear_chain_crf(torch.from_numpy(em), path,
                                 torch.from_numpy(trans),
                                 torch.from_numpy(ln))[:, 0]
    for i, n in enumerate(ln):
        best = max(_path_score(em[i], p, trans, n)
                   for p in itertools.product(range(3), repeat=int(n)))
        np.testing.assert_allclose(
            float(cost[i]), float(cost[i]) + best
            - _path_score(em[i], path[i].numpy(), trans, n), rtol=1e-6)
        assert (path[i, n:] == 0).all()


def test_viterbi_decode_matches_the_reference():
    r = np.random.RandomState(4)
    pots = r.randn(3, 6, 5).astype(np.float32)
    trans = r.randn(5, 5).astype(np.float32)
    js, jp = jtext.viterbi_decode(paddle.to_tensor(pots),
                                  paddle.to_tensor(trans))
    # lengths are accepted and not read, in both packages
    ts, tp = ttext.viterbi_decode(torch.from_numpy(pots),
                                  torch.from_numpy(trans),
                                  lengths=torch.tensor([6, 2, 1]))
    assert ts.dtype == torch.float32 and tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.numpy()))


def test_fake_text_dataset_matches_the_reference():
    j = jtext.FakeTextDataset(num_samples=5, seq_len=12, vocab_size=97,
                              seed=3)
    t = ttext.FakeTextDataset(num_samples=5, seq_len=12, vocab_size=97,
                              seed=3)
    assert len(t) == len(j) == 5
    for i in (0, 4):
        for a, b in zip(t[i], j[i]):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_static_crf_decoding_replays_the_eager_paths():
    em, _, trans, ln = _crf_inputs(np.random.RandomState(5), b=4, s=7, d=4,
                                   lengths=(7, 3, 1, 5))
    transition = torch.nn.Parameter(torch.from_numpy(trans))
    main = static.Program()
    with static.program_guard(main):
        x = static.data("em", [4, 7, 4], "float32", device="cpu")
        n = static.data("n", [4], "int64", device="cpu")
        path = static.nn.crf_decoding(x, transition, length=n)
    assert [op.name for op in main.ops] == ["crf_decoding"]
    exe = static.Executor(static.CPUPlace())
    got, = exe.run(main, feed={"em": em, "n": ln}, fetch_list=[path])
    want = tcrf.crf_decoding(torch.from_numpy(em), transition,
                             length=torch.from_numpy(ln))
    np.testing.assert_array_equal(np.asarray(got), want.numpy())
    with pytest.raises(ValueError, match="transition"):
        static.nn.crf_decoding(torch.from_numpy(em), None)


def test_both_packages_compute_in_the_inputs_dtype():
    """A bf16 step casts every float parameter, the transition too, and
    the emissions come from a bf16 Linear: the reference's recursion then
    runs in bf16, and so does the port's. The taggers below cast both to
    f32 first."""
    em, lbl, trans, ln = _crf_inputs(np.random.RandomState(6))
    ref = jax.jit(lambda e, t: jcrf.linear_chain_crf(e, lbl, t, ln)._value)(
        jnp.asarray(em, jnp.bfloat16), jnp.asarray(trans, jnp.bfloat16))
    got = tcrf.linear_chain_crf(torch.from_numpy(em).bfloat16(),
                                torch.from_numpy(lbl),
                                torch.from_numpy(trans).bfloat16(),
                                torch.from_numpy(ln))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    # bf16 rounds each step's state (8 bits); costs of ~10
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=0.25)


# -- the slice: a bert_tiny CRF tagger -----------------------------------------
class JTagger(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.bert = jbert.BertModel(cfg)
        self.cls = jnn.Linear(cfg.hidden_size, TAGS)
        self.transition = self.create_parameter([TAGS + 2, TAGS])

    def forward(self, ids, types, mask, labels, lengths):
        x, _ = self.bert(ids, types, mask)
        em = paddle.cast(self.cls(x), "float32")
        return jcrf.linear_chain_crf(em, labels, paddle.cast(
            self.transition, "float32"), lengths).mean()


class TTagger(torch.nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.bert = tbert.BertModel(cfg, device=device)
        self.cls = Linear(cfg.hidden_size, TAGS, device=device)
        self.transition = torch.nn.Parameter(
            torch.zeros(TAGS + 2, TAGS, device=device))

    def forward(self, ids, types, mask, labels, lengths):
        x, _ = self.bert(ids, types, mask)
        return tcrf.linear_chain_crf(self.cls(x).float(), labels,
                                     self.transition.float(), lengths).mean()


def _tagger_batch(b=4, s=16, vocab=1024):
    r = np.random.RandomState(7)
    ids = r.randint(0, vocab, (b, s)).astype(np.int64)
    lengths = np.array([16, 9, 12, 5], np.int64)[:b]
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int64)
    labels = r.randint(0, TAGS, (b, s)).astype(np.int64)
    return ids, np.zeros_like(ids), mask, labels, lengths


@pytest.fixture(scope="module")
def taggers():
    paddle.seed(0)
    jm = JTagger(jbert.bert_tiny())
    p0 = {k: np.asarray(v, np.float32)
          for k, v in jfunc.get_params(jm).items()}
    tm = load_jax_params(TTagger(tbert.bert_tiny(), "cpu"), p0)
    return jm, tm, p0


def test_tagger_loss_and_gradients_match_the_reference(taggers):
    jm, tm, p0 = taggers
    batch = _tagger_batch()
    apply = jfunc.functionalize(jm, training=True)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    loss_fn = lambda p: apply(p, {}, *batch)[0]
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tm.train()
    loss = tm(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= TAGGER_LOSS_TOL
    got = {n: p.grad for n, p in tm.named_parameters()
           if p.grad is not None}
    # the pooler does not reach the loss: no gradient on either side
    assert set(got) == {n for n, g in want_grads.items()
                        if np.abs(np.asarray(g)).max() > 0}
    assert float(got["transition"].abs().max()) > 0
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[n]),
                                   err_msg=n, **TAGGER_GRAD_TOL)


def test_tagger_adamw_steps_match_the_reference(taggers):
    _, _, p0 = taggers
    batch = _tagger_batch()
    paddle.seed(0)
    jm = JTagger(jbert.bert_tiny())
    jfunc.set_params(jm, {k: jnp.asarray(v) for k, v in p0.items()})
    jopt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                  parameters=jm.parameters())
    jstep = JStep(jm, loss_fn=lambda out, *_: out, optimizer=jopt,
                  mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)))
    want = [float(np.asarray(jstep(batch, (batch[3],)).numpy()))
            for _ in range(STEPS)]
    jstep.sync_to_layer()
    want_params = {k: np.asarray(v) for k, v in jfunc.get_params(jm).items()}

    tm = load_jax_params(TTagger(tbert.bert_tiny(), "cpu"), p0)
    opt = AdamW(LR, parameters=tm.parameters(), weight_decay=WD)
    step = ParallelTrainStep(tm, lambda out, *_: out, opt, device="cpu")
    tb = tuple(torch.from_numpy(a) for a in batch)
    got = [float(step(tb, (tb[3],))) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=0, atol=TAGGER_LOSS_TOL)
    assert got[1] < got[0]
    params = get_params(tm)
    for n, v in want_params.items():
        np.testing.assert_allclose(params[n].detach().numpy(), v, rtol=0,
                                   atol=TAGGER_PARAM_TOL, err_msg=n)
