"""The port's recompute policies (paddle_tpu_torch.ops.remat_policy): the
reference's vocabulary; on a 2-layer GPT with dropout 0.1, the loss and
every gradient under each ported policy are bitwise equal to 'off' (the
recomputed blocks draw the dropout masks they drew the first time, and
a forward on casts of the parameters recomputes on the same casts);
the recompute really runs (the LayerNorm forwards run twice, fewer bytes
are saved); 'offload' keeps the products on the host and 'auto' resolves
on the engine's first batch, both stepping to 'off''s losses."""
import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu.ops import remat_policy as jremat
from paddle_tpu_torch.distributed.fleet.engine import ParallelTrainStep
from paddle_tpu_torch.jit.functionalize import functionalize
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.ops import remat_policy as tremat
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.text.models import gpt as tgpt
import torch_threads  # noqa: F401  (one torch thread a worker)

PORTED = ("full", "nothing", "dots", "dots_no_batch", "offload")
VOCAB = (None, False, True, "off", "", "full", "nothing", "dots",
         "dots_no_batch", "offload", "auto")


@pytest.mark.parametrize("value", VOCAB)
def test_normalize_takes_the_references_vocabulary(value):
    assert tremat.normalize(value) == jremat.normalize(value)


def test_unknown_policies_are_refused_and_ids_match():
    for mod in (tremat, jremat):
        with pytest.raises(ValueError, match="unknown remat policy"):
            mod.normalize("everything")
    assert tremat.POLICY_IDS == jremat.POLICY_IDS


@pytest.mark.parametrize("policy", ["offload", "auto"])
def test_offload_and_auto_step_to_the_losses_of_off(policy):
    """Two steps of ParallelTrainStep under the policy give 'off''s loss
    bits (dropout 0.1: the recompute redraws the same masks; 'auto' on the
    CPU's 32 GB budget resolves to 'off')."""
    losses = {}
    for p in ("off", policy):
        model = _model()
        step = ParallelTrainStep(model, lambda out, lbl: out,
                                 Adam(1e-3, parameters=model.parameters()),
                                 device="cpu", remat=p)
        ids, labels = _batch()
        losses[p] = [step((ids, labels), (labels,)) for _ in range(2)]
        assert step.remat_policy_chosen == ("off" if p == "auto" else p)
    for a, b in zip(losses[policy], losses["off"]):
        assert torch.equal(a, b)


def _model():
    cfg = tgpt.gpt2_tiny(num_layers=2, hidden_dropout=0.1)
    return tgpt.GPTForCausalLM(cfg, device="cpu", seed=5)


def _batch():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 64))).long()
    return ids, torch.roll(ids, -1, dims=1)


def _grads(policy, compute_dtype=None):
    """Loss, gradients, LayerNorm forwards run and the dropout generator's
    state after one forward and backward under ``policy``."""
    model = _model()
    apply = tremat.apply_policy(
        functionalize(model, training=True, compute_dtype=compute_dtype),
        policy, model)
    calls = []
    ln = fused._ln_reference

    def counting(*a, **k):
        calls.append(1)
        return ln(*a, **k)

    fused._ln_reference = counting
    try:
        loss = apply(*_batch())
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        fused._ln_reference = ln
    return (loss, dict(zip(names, grads)), len(calls),
            model.gpt.dropout_gen.get_state())


@pytest.fixture(scope="module")
def off():
    return {cd: _grads("off", cd) for cd in (None, torch.bfloat16)}


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16_casts"])
@pytest.mark.parametrize("policy", PORTED)
def test_gradients_are_bitwise_those_of_off(off, policy, compute_dtype):
    loss0, grads0, calls0, gen0 = off[compute_dtype]
    loss, grads, calls, gen = _grads(policy, compute_dtype)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
    # 2 LayerNorms a block run again in the backward; ln_f lies outside
    # the blocks and runs once
    assert calls == calls0 + 2 * 2
    # the recompute put the generator back where the forward left it
    assert torch.equal(gen, gen0)


def test_dropout_is_on_in_the_comparison(off):
    model = _model()
    a = functionalize(model, training=True)(*_batch())
    b = functionalize(model, training=True)(*_batch())
    assert not torch.equal(a, b)  # masks differ from draw to draw
    assert torch.equal(off[None][0], _grads("off")[0])


def _saved_bytes(policy):
    model = _model()
    apply = tremat.apply_policy(functionalize(model, training=True), policy,
                                model)
    total = []

    def pack(t):
        total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = apply(*_batch())
    loss.backward()
    return sum(total)


def test_full_recompute_saves_fewer_bytes():
    # under 'full' only each block's input is saved for the backward
    assert _saved_bytes("full") < _saved_bytes("off") / 2


class _NoList(nn.Module):
    def __init__(self):
        super().__init__()
        self.generator = torch.Generator().manual_seed(3)
        self.fc = nn.Linear(8, 8)

    def forward(self, x):
        keep = torch.empty(x.shape).bernoulli_(0.5, generator=self.generator)
        return (torch.tanh(self.fc(x)) * keep).sum()


def test_a_layer_without_a_module_list_is_one_region():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 8)).float()
    out = {}
    for policy in ("off", "full", "dots"):
        torch.manual_seed(0)  # the same fc weights each time
        layer = _NoList()
        fn = tremat.apply_policy(layer, policy, layer)
        grads = torch.autograd.grad(fn(x), list(layer.parameters()))
        out[policy] = grads
    for policy in ("full", "dots"):
        for a, b in zip(out[policy], out["off"]):
            assert torch.equal(a, b)
