"""Checkpoints of the port (paddle_tpu_torch.framework.io save/load,
nn.set_state_dict and the optimizers' state_dict/set_state_dict) on the
CPU:

- nested dicts, lists and tuples of tensors (f32, bf16, int64, bool) and
  Python values come back with the same values, as tensors or numpy;
  parameters come back as parameters;
- a LeNet state dict written by the reference's `paddle_tpu.save` loads
  into the port and gives the reference's logits;
- the unpickler refuses any class but the payloads, numpy's
  reconstructors, OrderedDict and plain builtins;
- a file covered by a manifest loads when its CRC32 and size match and
  raises CheckpointIntegrityError on a flipped byte; `atomic_replace`
  leaves no temporary file;
- `cipher_key` writes an AES-GCM file in the reference's wire format:
  it round-trips, needs its key (a wrong key or a flipped byte fails),
  a file the reference encrypted loads in the port and a file the port
  encrypted (numpy leaves) loads in the reference;
- `set_state_dict` returns (missing, unexpected), raises on a shape
  mismatch, casts to the target's dtype and copies in place;
- the optimizer state dict round trip for Adam, AdamW and Momentum (with
  a scheduler; under multi_precision the f32 masters survive); 3 steps,
  a save, a load into a fresh model and optimizer and 3 more steps give
  the bits of 6 uninterrupted steps (through `_adam_reference`, the
  Adam kernel's plain version).

Tolerances: the reference's logits within 1e-5 of their largest
magnitude (two f32 forwards of the same weights); everything else bit
for bit.
"""
import collections
import json
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework import load, save
from paddle_tpu_torch.jit.train_step import EvalStep
from paddle_tpu_torch.nn import (CrossEntropyLoss, Linear, ReLU, Sequential,
                                 set_state_dict)
from paddle_tpu_torch.nn.layer.norm import BatchNorm1D
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum, lr as tlr
from paddle_tpu_torch.vision import models as tmodels
import torch_threads  # noqa: F401  (one torch thread a worker)

LOGIT_REL_TOL = 1e-5


def test_nested_state_round_trips(tmp_path):
    p = torch.nn.Parameter(torch.randn(3, 4))
    obj = {"a": torch.arange(6).reshape(2, 3),
           "b": [torch.randn(5), (torch.ones(2, dtype=torch.bool), 3.5)],
           "c": collections.OrderedDict(w=p, h=torch.randn(4).bfloat16()),
           "d": {"step": 7, "name": "x", "none": None}}
    path = str(tmp_path / "s.pdparams")
    save(obj, path)
    got = load(path)
    assert torch.equal(got["a"], obj["a"]) and got["a"].dtype == torch.int64
    assert torch.equal(got["b"][0], obj["b"][0])
    assert isinstance(got["b"][1], tuple) and got["b"][1][1] == 3.5
    assert torch.equal(got["b"][1][0], obj["b"][1][0])
    assert isinstance(got["c"], collections.OrderedDict)
    assert isinstance(got["c"]["w"], torch.nn.Parameter)
    assert torch.equal(got["c"]["w"], p) and got["c"]["w"].requires_grad
    # bf16 comes back widened to f32, the same values
    assert got["c"]["h"].dtype == torch.float32
    assert torch.equal(got["c"]["h"], obj["c"]["h"].float())
    assert got["d"] == obj["d"]
    as_np = load(path, return_numpy=True)
    assert isinstance(as_np["a"], np.ndarray)
    np.testing.assert_array_equal(as_np["c"]["w"], p.detach().numpy())
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    paddle.seed(0)
    ref = jmodels.LeNet()
    path = str(tmp_path / "lenet.pdparams")
    paddle.save(ref.state_dict(), path)
    port = tmodels.LeNet(device="cpu", seed=9)
    state = load(path)
    assert all(isinstance(v, torch.nn.Parameter) for v in state.values())
    missing, unexpected = set_state_dict(port, state)
    assert missing == [] and unexpected == []
    x = np.random.RandomState(1).randn(4, 1, 28, 28).astype(np.float32)
    ref.eval()
    want = ref(paddle.to_tensor(x)).numpy()
    got = EvalStep(port)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= LOGIT_REL_TOL * np.abs(want).max()
    # numpy straight from the reference's file
    arrays = load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["fc.2.bias"],
                                  ref.fc[2].bias.numpy())


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("obj", [_Evil(), {"x": collections.Counter(a=1)},
                                 [np.random.RandomState(0)]])
def test_loader_refuses_other_classes(tmp_path, obj):
    path = str(tmp_path / "bad.pdparams")
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="may not hold"):
        load(path)


def test_manifest_crc_catches_a_flipped_byte(tmp_path):
    path = str(tmp_path / "m.pdparams")
    w = torch.randn(64)
    save({"w": w}, path)
    with open(tmp_path / tio.MANIFEST_NAME, "w") as f:
        json.dump({"files": {"m.pdparams": {
            "crc32": tio.file_crc32(path),
            "size": os.path.getsize(path)}}}, f)
    assert tio.verify_against_manifest(path) is True
    load(path)
    raw = bytearray(open(path, "rb").read())
    raw[raw.find(w.numpy().tobytes()) + 10] ^= 0x01  # one bit of the data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tio.CheckpointIntegrityError, match="crc32"):
        load(path)
    # verify=False is for a caller that has already hashed the file
    assert not torch.equal(load(path, verify=False)["w"], w)


def test_cipher_key_is_not_ported(tmp_path):
    """The name is kept from when ``cipher_key`` raised; encrypted
    checkpoints are ported now (``framework.io_crypto``)."""
    from cryptography.exceptions import InvalidTag

    key = bytes(range(32))
    w = torch.randn(3, 4)
    path = str(tmp_path / "e.pdparams")
    save({"w": w, "step": 3}, path, cipher_key=key)
    raw = open(path, "rb").read()
    assert raw.startswith(b"PDENC\x01") and w.numpy().tobytes() not in raw
    got = load(path, cipher_key=key)
    assert torch.equal(got["w"], w) and got["step"] == 3
    with pytest.raises(ValueError, match="encrypted"):
        load(path)
    with pytest.raises(InvalidTag):
        load(path, cipher_key=bytes(32))
    bad = bytearray(raw)
    bad[-1] ^= 0x01
    open(path, "wb").write(bytes(bad))
    with pytest.raises(InvalidTag):
        load(path, cipher_key=key)
    # the reference's encrypted file loads in the port with the same key
    ref_path = str(tmp_path / "ref.pdparams")
    paddle.save({"w": paddle.to_tensor(w.numpy()), "n": 5}, ref_path,
                cipher_key=key)
    got = load(ref_path, cipher_key=key)
    assert torch.equal(got["w"], w) and got["n"] == 5
    # and the port's (numpy leaves) in the reference
    port_path = str(tmp_path / "port.pdparams")
    save({"w": w.numpy(), "lr": 0.5}, port_path, cipher_key=key)
    got = paddle.load(port_path, cipher_key=key)
    np.testing.assert_array_equal(got["w"], w.numpy())
    assert got["lr"] == 0.5


def test_set_state_dict_semantics():
    net = Sequential(Linear(4, 3, generator=torch.Generator()),
                     BatchNorm1D(3))
    weight = net[0].weight
    state = {"0.weight": np.full((4, 3), 2.0, np.float64),
             "1._mean": torch.full((3,), 0.5), "extra": torch.zeros(1)}
    missing, unexpected = set_state_dict(net, state)
    assert unexpected == ["extra"]
    assert missing == ["0.bias", "1.weight", "1.bias", "1._variance"]
    assert net[0].weight is weight and weight.dtype == torch.float32
    assert torch.equal(weight, torch.full((4, 3), 2.0))
    assert torch.equal(net[1]._mean, torch.full((3,), 0.5))
    with pytest.raises(ValueError, match="shape mismatch"):
        set_state_dict(net, {"0.weight": torch.zeros(3, 4)})
    net16 = Sequential(Linear(4, 3, generator=torch.Generator())).to(
        torch.bfloat16)
    set_state_dict(net16, {"0.weight": torch.full((4, 3), 1.001)})
    assert net16[0].weight.dtype == torch.bfloat16
    assert torch.equal(net16[0].weight,
                       torch.full((4, 3), 1.001).bfloat16())


def _mlp(seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return Sequential(Linear(8, 16, generator=gen), ReLU(),
                      Linear(16, 4, generator=gen)).to(dtype)


_OPTIMIZERS = {
    "adam": lambda ps, sched: Adam(sched, parameters=ps),
    "adamw": lambda ps, sched: AdamW(sched, parameters=ps,
                                     weight_decay=0.05),
    "momentum": lambda ps, sched: Momentum(sched, 0.9, parameters=ps),
    "adam_master": lambda ps, sched: Adam(sched, parameters=ps,
                                          multi_precision=True),
}


def _train(net, opt, n, seed=0):
    rng = np.random.RandomState(seed)
    dtype = next(net.parameters()).dtype
    for _ in range(n):
        x = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).to(dtype)
        y = torch.from_numpy(rng.randint(0, 4, 6).astype(np.int64))
        CrossEntropyLoss()(net(x).float(), y).backward()
        opt.step()
        opt.clear_grad()
        opt._learning_rate.step()


def _run(kind, net, state=None, steps=3, seed=0):
    sched = tlr.StepDecay(1e-2, step_size=2, gamma=0.5)
    opt = _OPTIMIZERS[kind](net.parameters(), sched)
    opt.name_parameters(net.named_parameters())
    if state is not None:
        opt.set_state_dict(state)
    _train(net, opt, steps, seed)
    return opt


@pytest.mark.parametrize("kind", sorted(_OPTIMIZERS))
def test_resume_equals_uninterrupted_steps(kind, tmp_path):
    dtype = torch.bfloat16 if kind == "adam_master" else torch.float32
    whole = _mlp(0, dtype)
    whole_opt = _run(kind, whole, steps=3)
    _train(whole, whole_opt, 3, seed=1)

    half = _mlp(0, dtype)
    half_opt = _run(kind, half, steps=3)
    save(half.state_dict(), str(tmp_path / "w.pdparams"))
    save(half_opt.state_dict(), str(tmp_path / "w.pdopt"))
    fresh = _mlp(5, dtype)
    set_state_dict(fresh, load(str(tmp_path / "w.pdparams")))
    opt_state = load(str(tmp_path / "w.pdopt"))
    assert opt_state["global_step"] == 3
    assert opt_state["LR_Scheduler"]["last_epoch"] == 3
    if kind == "adam_master":
        assert "0.weight__master" in opt_state
    fresh_opt = _run(kind, fresh, opt_state, steps=3, seed=1)

    for (n, a), b in zip(whole.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n
    ws, fs = whole_opt.state_dict(), fresh_opt.state_dict()
    assert ws.keys() == fs.keys()
    for k, v in ws.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fs[k]), k
        else:
            assert v == fs[k], k


def test_state_dict_layout_and_in_place_restore():
    net = _mlp(0)
    opt = _run("adam", net, steps=2)
    state = opt.state_dict()
    names = [n for n, _ in net.named_parameters()]
    assert set(state) == {"global_step", "LR_Scheduler"} | {
        f"{n}__{k}" for n in names
        for k in ("moment1", "moment2", "beta1_pow", "beta2_pow")}
    twin = _mlp(0)
    opt2 = _run("adam", twin, steps=0)
    moment = opt2.state_for(next(twin.parameters()))["moment1"]
    opt2.set_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor)
                             else v) for k, v in state.items()})
    # restored into the tensors the state already had
    assert opt2.state_for(next(twin.parameters()))["moment1"] is moment
    for k, v in opt2.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, state[k]), k
    # without names, the position in the parameter list
    bare = Adam(1e-3, parameters=_mlp(0).parameters())
    bare.state_for(bare._parameter_list[1])
    assert "1__moment2" in bare.state_dict()
