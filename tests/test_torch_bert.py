"""The port's BERT (paddle_tpu_torch.text.models.bert) against the
reference's: bert_tiny with the reference's weights carried across, MLM
and NSP logits with and without a padding mask, the pretraining loss, and
three `ParallelTrainStep` steps with AdamW against the reference engine on
a 1-device mesh — in f32 (with `apply_decay_param_fun` excluding biases
and LayerNorms by name) and in bf16 compute without master weights; the
non-master engine mode; the attention dispatch, which raises off the CPU
where the kernel cannot take a call and hands a key-padding bias to the
full-attention kernels; the shared `nn.layer` modules."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.engine import ParallelTrainStep as JStep
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch import bench
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import get_params, load_jax_params
from paddle_tpu_torch.nn.layer import common, norm
from paddle_tpu_torch.ops import attention as tatt
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import bert as tbert
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

jfunc = importlib.import_module("paddle_tpu.jit.functionalize")

# f32: the same math, summed in other orders (materialized softmax here,
# the blockwise recurrence in the reference)
LOGITS_TOL = 1e-4
LOSS_TOL = 1e-5
TRAIN_LOSS_TOL = 5e-6
PARAM_TOL = 1e-5
LR, WD, STEPS = 1e-3, 0.01, 3
# bf16 compute without masters: the reference rounds the MLM loss to bf16
# (one ulp is 2^-6 at 4-8, so a rounding is up to 0.016) and rounds the
# activations at other places than the port; three steps move each f32
# parameter by ~lr, and a bf16-rounded gradient can flip its sign
BF16_LOSS_TOL = 0.04
BF16_PARAM_TOL = 2 * LR * STEPS
# bf16 at bert_base's width, loss 10-14: one bf16 ulp of the reference's
# MLM loss is 2^-4 there (a rounding is up to 0.031), and 4096 tokens'
# activations are rounded at other places than the port's
BASE_BF16_LOSS_TOL = 0.1


def _no_decay(name):
    return not (name.endswith("bias") or ".ln" in name or "_ln." in name)


def _batch(b=4, L=32, vocab=1024, seed=0):
    """ids, MLM labels (15% of positions, -100 elsewhere) and NSP labels,
    as `bench_all.bench_bert_dp` makes them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, L)).astype(np.int32)
    mlm = np.where(rng.rand(b, L) < 0.15, ids, -100).astype(np.int32)
    nsp = rng.randint(0, 2, b).astype(np.int64)
    return ids, mlm, nsp


def _jax_model(seed=0):
    paddle.seed(seed)
    return jbert.BertForPretraining(jbert.bert_tiny())


def _np(params):
    return {k: np.asarray(v, dtype=np.float32) for k, v in params.items()}


def _port_model(p0):
    return load_jax_params(tbert.BertForPretraining(tbert.bert_tiny(),
                                                    device="cpu"), p0)


@pytest.fixture(scope="module")
def pair():
    jm = _jax_model()
    p0 = _np(jfunc.get_params(jm))
    jm.eval()
    tm = _port_model(p0).eval()
    return jm, tm, p0


def test_parameter_names_and_shapes_match_the_reference(pair):
    _, tm, p0 = pair
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == {n: a.shape for n, a in p0.items()}


def test_bert_base_has_the_reference_parameter_count():
    model = tbert.BertForPretraining(tbert.bert_base(), device="cpu")
    params = list(model.parameters())
    assert len(params) == 157
    assert sum(p.numel() for p in params) == 110_080_514


@pytest.mark.parametrize("masked", [False, True])
def test_logits_match_reference(pair, masked):
    jm, tm, _ = pair
    ids = _batch()[0].astype(np.int64)
    mask = None
    if masked:
        mask = np.ones(ids.shape, np.float32)
        mask[1, 20:] = 0.0
        mask[3, 5:] = 0.0
    lj, nj = jm(paddle.to_tensor(ids), None,
                None if mask is None else paddle.to_tensor(mask))
    with torch.no_grad():
        lt, nt = tm(torch.from_numpy(ids), None,
                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(lt.numpy(), lj.numpy(), atol=LOGITS_TOL,
                               rtol=0)
    np.testing.assert_allclose(nt.numpy(), nj.numpy(), atol=LOGITS_TOL,
                               rtol=0)


def test_token_types_and_sequence_classifier_match_reference(pair):
    _, _, p0 = pair
    ids = _batch()[0].astype(np.int64)
    tt = (np.arange(ids.shape[1])[None, :] >= 16).astype(np.int64)
    tt = np.repeat(tt, ids.shape[0], axis=0)
    paddle.seed(0)
    jc = jbert.BertForSequenceClassification(jbert.bert_tiny(), 3)
    jc.eval()
    pc = _np(jfunc.get_params(jc))
    tc = load_jax_params(tbert.BertForSequenceClassification(
        tbert.bert_tiny(), 3, device="cpu"), pc).eval()
    ref = jc(paddle.to_tensor(ids), paddle.to_tensor(tt)).numpy()
    with torch.no_grad():
        got = tc(torch.from_numpy(ids), torch.from_numpy(tt)).numpy()
    np.testing.assert_allclose(got, ref, atol=LOGITS_TOL, rtol=0)


def test_ernie_model_is_the_bert_encoder(pair):
    _, _, p0 = pair
    enc = {k[len("bert."):]: v for k, v in p0.items()
           if k.startswith("bert.")}
    ernie = load_jax_params(tbert.ErnieModel(tbert.bert_tiny(),
                                             device="cpu"), enc).eval()
    bert = load_jax_params(tbert.BertModel(tbert.bert_tiny(), device="cpu"),
                           enc).eval()
    ids = torch.from_numpy(_batch()[0].astype(np.int64))
    with torch.no_grad():
        assert torch.equal(ernie(ids)[0], bert(ids)[0])
    assert tbert.ernie_3_0_medium().vocab_size == 40064
    assert tbert.ernie_1_5b(num_layers=2).num_layers == 2


def test_loss_matches_reference(pair):
    jm, tm, _ = pair
    ids, mlm, nsp = _batch()
    ref = jm.loss_fn(jm(paddle.to_tensor(ids.astype(np.int64))),
                     paddle.to_tensor(mlm), paddle.to_tensor(nsp))
    with torch.no_grad():
        got = tm.loss_fn(tm(torch.from_numpy(ids).long()),
                         torch.from_numpy(mlm), torch.from_numpy(nsp))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(np.asarray(ref.numpy()))) <= LOSS_TOL


def test_masked_lm_loss_ignores_unmasked_positions():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(2, 6, 11).astype(np.float32))
    labels = torch.full((2, 6), -100)
    labels[0, 2], labels[1, 5] = 3, 7
    got = tbert._masked_ce(logits, labels)
    picked = torch.log_softmax(logits, -1)[[0, 1], [2, 5], [3, 7]]
    torch.testing.assert_close(got, -picked.mean())
    assert float(tbert._masked_ce(logits, torch.full((2, 6), -100))) == 0.0


def _run_reference(compute_dtype, decay_fun):
    model = _jax_model()
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=model.parameters(),
                                 apply_decay_param_fun=decay_fun)
    step = JStep(model, loss_fn=model.loss_fn, optimizer=opt,
                 mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                 compute_dtype=compute_dtype)
    ids, mlm, nsp = _batch()
    losses = [float(np.asarray(step((ids,), (mlm, nsp)).numpy()))
              for _ in range(STEPS)]
    step.sync_to_layer()
    return losses, _np(jfunc.get_params(model))


def _run_port(p0, compute_dtype, decay_fun):
    model = _port_model(p0)
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=WD,
                apply_decay_param_fun=decay_fun)
    step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             device="cpu", compute_dtype=compute_dtype)
    ids, mlm, nsp = (torch.from_numpy(a).long() for a in _batch())
    losses = [step((ids,), (mlm, nsp)) for _ in range(STEPS)]
    return losses, model, opt


@pytest.fixture(scope="module")
def f32_runs(pair):
    p0 = pair[2]
    ref_losses, ref_params = _run_reference(None, _no_decay)
    losses, model, _ = _run_port(p0, None, _no_decay)
    return p0, ref_losses, ref_params, losses, _np(get_params(model))


@pytest.fixture(scope="module")
def bf16_runs(pair):
    p0 = pair[2]
    ref_losses, ref_params = _run_reference(jnp.bfloat16, None)
    losses, model, opt = _run_port(p0, torch.bfloat16, None)
    return ref_losses, ref_params, losses, model, opt


@pytest.mark.parametrize("i", range(STEPS))
def test_f32_adamw_loss_of_each_step_matches_reference(f32_runs, i):
    _, ref_losses, _, losses, _ = f32_runs
    assert losses[i].dtype == torch.float32 and losses[i].dim() == 0
    assert abs(float(losses[i]) - ref_losses[i]) <= TRAIN_LOSS_TOL


def test_f32_adamw_params_after_three_steps_match_reference(f32_runs):
    p0, _, ref_params, losses, params = f32_runs
    assert float(losses[-1]) < float(losses[0])
    moved = max(float(np.abs(ref_params[n] - p0[n]).max()) for n in p0)
    assert moved > 10 * PARAM_TOL  # the comparison is not vacuous
    for name, ref in ref_params.items():
        np.testing.assert_allclose(params[name], ref, atol=PARAM_TOL,
                                   rtol=0, err_msg=name)


def test_decay_fun_sees_the_reference_names(f32_runs):
    """The excluded tensors are the ones the reference excluded: a LayerNorm
    gain that saw no decay is the same on both sides, and the names the
    function was asked about are the reference's parameter names."""
    asked = []
    model = _port_model(f32_runs[0])
    opt = AdamW(LR, parameters=model.parameters(), weight_decay=WD,
                apply_decay_param_fun=lambda n: asked.append(n) or True)
    step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             device="cpu")
    ids, mlm, nsp = (torch.from_numpy(a).long() for a in _batch())
    step((ids,), (mlm, nsp))
    assert sorted(asked) == sorted(f32_runs[0])


@pytest.mark.parametrize("i", range(STEPS))
def test_bf16_without_masters_loss_matches_reference(bf16_runs, i):
    ref_losses, _, losses, _, _ = bf16_runs
    assert abs(float(losses[i]) - ref_losses[i]) <= BF16_LOSS_TOL


def test_bf16_without_masters_params_match_reference(bf16_runs):
    _, ref_params, _, model, _ = bf16_runs
    for name, p in get_params(model).items():
        np.testing.assert_allclose(p.numpy(), ref_params[name],
                                   atol=BF16_PARAM_TOL, rtol=0,
                                   err_msg=name)


def test_bf16_without_masters_keeps_f32_residents_and_no_masters(bf16_runs):
    _, _, _, model, opt = bf16_runs
    for p in model.parameters():
        assert p.dtype == torch.float32
        st = opt.state_for(p)
        assert "master" not in st
        assert st["moment1"].dtype == torch.float32


@pytest.fixture(scope="module")
def bert_base_bf16_curves():
    """Three AdamW steps (lr 1e-4, decay 0.01, as `bench_bert_dp`) of
    bert_base cut to 2 layers, full width, at the bench's batch 32 x 128,
    bf16 compute without masters: the reference engine's losses and the
    port's from the same weights and batch."""
    kw = dict(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
    batch = _batch(b=32, L=128, vocab=30528)
    paddle.seed(0)
    jm = jbert.BertForPretraining(jbert.bert_base(**kw))
    p0 = _np(jfunc.get_params(jm))
    opt = paddle.optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                                 parameters=jm.parameters())
    step = JStep(jm, loss_fn=jm.loss_fn, optimizer=opt,
                 mesh=Mesh(np.array(jax.devices()[:1]), ("dp",)),
                 compute_dtype=jnp.bfloat16)
    ref = [float(np.asarray(step((batch[0],), batch[1:]).numpy()))
           for _ in range(STEPS)]
    del jm, opt, step
    tm = load_jax_params(tbert.BertForPretraining(tbert.bert_base(**kw),
                                                  device="cpu"), p0)
    topt = AdamW(1e-4, parameters=tm.parameters(), weight_decay=0.01)
    tstep = ParallelTrainStep(tm, loss_fn=tm.loss_fn, optimizer=topt,
                              device="cpu", compute_dtype=torch.bfloat16)
    ids, mlm, nsp = (torch.from_numpy(a).long() for a in batch)
    got = [float(tstep((ids,), (mlm, nsp))) for _ in range(STEPS)]
    print(f"bert_base(num_layers=2) bf16 losses: reference {ref}, port {got}")
    return ref, got


@pytest.mark.parametrize("i", range(STEPS))
def test_bert_base_bf16_loss_curve_follows_the_reference(
        bert_base_bf16_curves, i):
    """At full width the loss rises at the second step before it falls, on
    both sides: the port follows the reference's curve step by step."""
    ref, got = bert_base_bf16_curves
    assert ref[1] > ref[0] and got[1] > got[0]
    assert abs(got[i] - ref[i]) <= BASE_BF16_LOSS_TOL


def test_bf16_without_masters_runs_the_forward_in_bf16():
    model = tbert.BertForPretraining(tbert.bert_tiny(), device="cpu")
    seen = []
    model.bert.encoder[0].attn.qkv.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    opt = AdamW(LR, parameters=model.parameters())
    step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                             device="cpu", compute_dtype=torch.bfloat16)
    ids, mlm, nsp = (torch.from_numpy(a).long() for a in _batch())
    loss = step((ids,), (mlm, nsp))
    assert seen == [torch.bfloat16] and loss.dtype == torch.float32
    assert all(p.grad is None for p in model.parameters())  # cleared


def test_dropout_draws_from_the_models_generator():
    cfg = tbert.bert_tiny(hidden_dropout=0.1, attention_dropout=0.1)
    ids = torch.from_numpy(_batch()[0]).long()
    outs = []
    for global_seed in (0, 123):
        torch.manual_seed(global_seed)  # the global RNG plays no part
        model = tbert.BertForPretraining(cfg, device="cpu", seed=4).train()
        outs.append(model(ids)[0])
    assert torch.equal(outs[0], outs[1])
    model.eval()
    assert not torch.equal(model(ids)[0], outs[0])  # dropout was on


def _meta_qkv(L=16, H=2, d=64, Lk=None):
    q = torch.empty(2, L, H, d, device="meta")
    k = torch.empty(2, Lk or L, H, d, device="meta")
    return q, k


@pytest.mark.parametrize("d,Lk,match", [(48, None, "head dim 48"),
                                        (64, 24, "self-attention only")])
def test_kernel_shapes_it_cannot_take_raise_off_the_cpu(d, Lk, match):
    """Off the CPU, a call the kernel cannot take raises: nothing goes to
    the plain path (tensors on the meta device stand in for the card's: no
    kernel runs)."""
    q, k = _meta_qkv(d=d, Lk=Lk)
    for causal in (False, True):
        for layout in ("blhd", "bhld"):
            with pytest.raises(ValueError, match=match):
                tatt.dot_product_attention(q, k, k, causal=causal,
                                           layout=layout)


@pytest.mark.parametrize("shape,causal", [
    ((2, 2, 16, 16), False),   # per head and per query
    ((2, 1, 16, 16), False),   # per query
    ((2, 2, 1, 16), False),    # per head
    ((3, 1, 1, 16), False),    # another batch
    ((2, 1, 1, 16), True)])    # a key-padding bias, but causal
def test_biased_calls_raise_off_the_cpu(shape, causal):
    """Off the CPU only a key-padding bias ([b, 1, 1, Lk]) of full
    attention has a kernel; every other bias raises rather than taking the
    plain path."""
    q, _ = _meta_qkv()
    bias = torch.zeros(*shape, device="meta")
    for layout, x in (("blhd", q), ("bhld", q.transpose(1, 2))):
        with pytest.raises(NotImplementedError, match="bias"):
            tatt.dot_product_attention(x, x, x, causal=causal, bias=bias,
                                       layout=layout)


@pytest.mark.parametrize("shape", [(2, 1, 1, 16), (1, 1, 1, 16), (2, 16),
                                   (16,)])
def test_key_padding_bias_off_the_cpu_reaches_the_kernel(shape):
    """A bias that broadcasts as [b, 1, 1, Lk] goes to the full-attention
    kernel's wrapper (which raises on the meta device, as no kernel runs
    there) in either layout."""
    q, _ = _meta_qkv()
    bias = torch.zeros(*shape, device="meta")
    if len(shape) == 2:
        bias = bias[:, None, None, :]
    for layout, x in (("blhd", q), ("bhld", q.transpose(1, 2))):
        with pytest.raises(ValueError, match="unsupported device"):
            tatt.dot_product_attention(x, x, x, bias=bias, layout=layout)


def test_key_padding_bias_that_requires_grad_raises():
    """The kernels give the bias no gradient, so one that asks for it
    raises (on the CPU the plain path differentiates it)."""
    q, _ = _meta_qkv()
    bias = torch.zeros(2, 1, 1, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tatt.dot_product_attention(q, q, q, bias=bias, layout="blhd")


def test_masked_bert_dispatches_the_mask_as_a_key_bias(monkeypatch):
    """BertModel's attention_mask reaches the full-attention kernels as the
    reference's -1e9 bias on the padded keys, f32 [b, L]: the bias the
    dispatch builds, run through the kernels' plain version on the CPU,
    gives the masked model's logits."""
    model = tbert.BertModel(tbert.bert_tiny(), device="cpu").eval()
    ids = torch.from_numpy(_batch(b=2, L=24)[0]).long()
    mask = torch.ones(2, 24)
    mask[1, 9:] = 0.0
    seen = []

    def through_kernel_path(q, k, v, causal=False, bias=None, layout="bhld"):
        kb = tatt._key_bias(bias, q.shape[0], k.shape[1])
        seen.append(kb)
        return tatt.flash_attention(q, k, v, causal, layout, key_bias=kb)

    with torch.no_grad():
        want, _ = model(ids, None, mask)
        monkeypatch.setattr(tbert, "dot_product_attention",
                            through_kernel_path)
        got, _ = model(ids, None, mask)
    assert len(seen) == model.config.num_layers
    assert seen[0].dtype == torch.float32 and seen[0].shape == (2, 24)
    assert torch.equal(seen[0][1, 9:], torch.full((15,), -1e9))
    assert torch.equal(seen[0][0], torch.zeros(24))
    torch.testing.assert_close(got, want, atol=LOGITS_TOL, rtol=0)


def test_unbiased_kernel_calls_off_the_cpu_reach_the_kernel():
    """A shape the kernel takes is never rerouted: on a device that is
    neither the CPU nor the card, the kernel's wrapper raises."""
    q, _ = _meta_qkv()
    for causal in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            tatt.dot_product_attention(q, q, q, causal=causal,
                                       layout="blhd")


def test_gpt_uses_the_shared_layers():
    assert tgpt.Linear is common.Linear
    assert tgpt.Dropout is common.Dropout
    assert tgpt.LayerNorm is norm.LayerNorm
    model = tgpt.GPTForCausalLM(tgpt.gpt2_tiny(), device="cpu")
    assert isinstance(model.gpt.wte, common.Embedding)


def test_bench_flops_per_token_follow_bench_all():
    cfg = tbert.bert_base()
    assert bench.bert_flops_per_token(cfg) == 6 * 86e6 + 6 * 768 * 30528


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_f32_adamw_step_matches_the_cpu_plain_path(cuda_device, pair):
    """One f32 AdamW step of bert_tiny through the card's kernels (full
    attention forward/dQ/dK-dV, LayerNorm, Adam) against the same step on
    the CPU's plain path."""
    from paddle_tpu_torch.ops import flash_tpu

    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for dev in ("cpu", cuda_device):
        model = load_jax_params(tbert.BertForPretraining(
            tbert.bert_tiny(), device=dev), pair[2])
        opt = AdamW(LR, parameters=model.parameters(), weight_decay=WD)
        step = ParallelTrainStep(model, loss_fn=model.loss_fn, optimizer=opt,
                                 device=dev)
        ids, mlm, nsp = (torch.from_numpy(a).long().to(dev)
                         for a in _batch())
        before = flash_tpu.flash_bwd_dkv_full.launches
        loss = float(step((ids,), (mlm, nsp)))
        launched = flash_tpu.flash_bwd_dkv_full.launches - before
        results.append((loss, {n: p.detach().cpu() for n, p in
                               model.named_parameters()}, launched))
    (loss_c, params_c, n_c), (loss_g, params_g, n_g) = results
    assert (n_c, n_g) == (0, tbert.bert_tiny().num_layers)
    assert abs(loss_c - loss_g) <= LOSS_TOL
    for name, p in params_c.items():
        torch.testing.assert_close(params_g[name], p, atol=PARAM_TOL, rtol=0)
