"""The hapi tail of the port against the reference, on the CPU:

- `flops` / `dynamic_flops`: the same integer totals as the reference's
  on LeNet [1, 1, 28, 28], ResNet-50 and MobileNetV1 [1, 3, 224, 224]
  (the reference's counted under `jax.eval_shape`: its hooks read shapes
  alone, so its model is built and run abstractly), a `custom_ops`
  override and the per-layer table;
- `hub.list` / `help` / `load` of a local `hubconf.py`, its dependency
  check, and the remote sources refused;
- `framework.io_crypto`: key files, AES-GCM round trips and tampering,
  blobs and files that each package encrypted decrypted by the other, the
  `ImportError` that names `cryptography` where it is missing, and an
  encrypted `.pdexport` served by a Predictor with `set_cipher_key` /
  `set_cipher_key_file` with the plain artifact's bits.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from cryptography.exceptions import InvalidTag

from paddle_tpu.core.tensor import wrap_raw
from paddle_tpu.framework import io_crypto as jcrypto
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch as ptt
from paddle_tpu_torch import inference, jit, nn
from paddle_tpu_torch.framework import io_crypto as tcrypto
from paddle_tpu_torch.hapi import dynamic_flops
from paddle_tpu_torch.vision import models as tmodels
import torch_threads  # noqa: F401  (one torch thread a worker)

jdf = importlib.import_module("paddle_tpu.hapi.dynamic_flops")


def _ref_flops(make, shape):
    """The reference's ``dynamic_flops`` total of ``make()`` on an input
    of ``shape``, built and run under ``jax.eval_shape``."""
    out = []

    def count(x):
        out.append(jdf.dynamic_flops(make(), wrap_raw(x)))
        return x

    jax.eval_shape(count, jax.ShapeDtypeStruct(shape, jnp.float32))
    return out[0]


@pytest.mark.parametrize("name", ["LeNet", "resnet50", "mobilenet_v1"])
def test_flops_match_the_reference(name, capsys):
    shape = [1, 1, 28, 28] if name == "LeNet" else [1, 3, 224, 224]
    want = _ref_flops(getattr(jmodels, name), shape)
    got = ptt.flops(getattr(tmodels, name)(device="cpu"), shape)
    assert isinstance(got, int) and got == want > 0
    assert "Total Flops: " in capsys.readouterr().out


def test_flops_custom_ops_and_detail(capsys):
    net = nn.Sequential(nn.Linear(8, 4, device="cpu"), nn.ReLU(),
                        nn.Linear(4, 2, device="cpu"))
    assert ptt.flops(net, [3, 8]) == 8 * 3 * 4 + 4 * 3 * 2

    def doubled(m, x, y):
        m.total_ops += 2 * int(np.prod(y.shape))

    total = ptt.flops(net, [3, 8], custom_ops={nn.ReLU: doubled},
                      print_detail=True)
    out = capsys.readouterr().out
    assert total == 8 * 3 * 4 + 2 * 3 * 4 + 4 * 3 * 2
    assert "Customize Function has been applied" in out
    assert "| Layer Name" in out and "[3, 8]" in out
    # the hooks are gone and the mode restored
    net.train()
    dynamic_flops.dynamic_flops(net, torch.zeros(3, 8))
    assert net.training and not hasattr(net[0], "total_ops")
    with pytest.raises(TypeError):
        ptt.flops(lambda x: x, [1])


# -- hub ---------------------------------------------------------------------------
HUBCONF = '''
dependencies = ["numpy"]


def lenet(seed=0):
    """LeNet of the port on the CPU."""
    from paddle_tpu_torch.vision.models import LeNet

    return LeNet(device="cpu")


def _private():
    pass
'''


def test_hub_local_repo(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    repo = str(tmp_path)
    assert ptt.hub.list(repo) == ["lenet"]
    assert ptt.hub.help(repo, "lenet") == "LeNet of the port on the CPU."
    net = ptt.hub.load(repo, "lenet", seed=1)
    assert isinstance(net, tmodels.LeNet)
    with pytest.raises(ValueError, match="no entry point"):
        ptt.hub.load(repo, "missing")
    for source in ("github", "gitee"):
        with pytest.raises(ValueError, match="source='local'"):
            ptt.hub.list(repo, source=source)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ptt.hub.list(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="not a directory"):
        ptt.hub.list(str(tmp_path / "nowhere"))
    (tmp_path / "hubconf.py").write_text(
        HUBCONF.replace('"numpy"', '"no_such_module_here"'))
    with pytest.raises(RuntimeError, match="no_such_module_here"):
        ptt.hub.load(repo, "lenet")


# -- io_crypto ------------------------------------------------------------------------
def test_cipher_round_trips_between_the_packages(tmp_path):
    key = tcrypto.CipherUtils.gen_key(256)
    assert len(key) == 32
    port, ref = tcrypto.AESCipher(key), jcrypto.AESCipher(key)
    blob = port.encrypt(b"weights")
    assert blob.startswith(tcrypto.MAGIC) and len(blob) == 6 + 12 + 7 + 16
    assert ref.decrypt(blob) == b"weights"
    assert port.decrypt(ref.encrypt(b"program")) == b"program"
    path = str(tmp_path / "a.bin")
    ref.encrypt_to_file(b"x" * 100, path)
    assert tcrypto.is_encrypted(path) and port.decrypt_from_file(path) == \
        b"x" * 100
    tampered = bytearray(blob)
    tampered[-1] ^= 1
    with pytest.raises(InvalidTag):
        port.decrypt(bytes(tampered))
    with pytest.raises(ValueError, match="PDENC"):
        port.decrypt(b"plain")
    with pytest.raises(ValueError):
        tcrypto.AESCipher(b"short")
    with pytest.raises(ValueError):
        tcrypto.CipherUtils.gen_key(100)
    assert not tcrypto.is_encrypted(str(tmp_path / "missing"))


def test_key_files(tmp_path):
    p = str(tmp_path / "keys" / "k.key")
    key = tcrypto.CipherUtils.gen_key_to_file(p, 128)
    assert tcrypto.CipherUtils.read_key_from_file(p) == key
    assert jcrypto.CipherUtils.read_key_from_file(p) == key
    with open(p, "wb") as f:
        f.write(key + b"\n")
    assert tcrypto.CipherUtils.read_key_from_file(p) == key
    with open(p, "wb") as f:
        f.write(b"abc")
    with pytest.raises(ValueError, match="3 bytes"):
        tcrypto.CipherUtils.read_key_from_file(p)


def test_missing_cryptography_is_named(monkeypatch):
    monkeypatch.setitem(sys.modules,
                        "cryptography.hazmat.primitives.ciphers.aead", None)
    with pytest.raises(ImportError, match="cryptography"):
        tcrypto.AESCipher(bytes(32))


def test_encrypted_export_serves_the_plain_bits(tmp_path):
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                        nn.Linear(16, 4, device="cpu"))
    spec = [jit.InputSpec([None, 8], "float32", "x")]
    key = bytes(range(32))
    plain, secret = str(tmp_path / "plain"), str(tmp_path / "secret")
    jit.save(net, plain, input_spec=spec)
    jit.save(net, secret, input_spec=spec, encrypt_key=key)
    assert tcrypto.is_encrypted(secret + ".pdexport")
    assert tcrypto.is_encrypted(secret + ".pdiparams")
    x = np.random.RandomState(0).randn(3, 8).astype(np.float32)

    def serve(prefix, set_key=None):
        cfg = inference.Config(prefix)
        cfg.disable_gpu()
        if set_key:
            set_key(cfg)
        return inference.create_predictor(cfg).run([x])[0]

    want = serve(plain)
    got = serve(secret, lambda c: c.set_cipher_key(key))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    key_file = str(tmp_path / "k.key")
    with open(key_file, "wb") as f:
        f.write(key)
    got = serve(secret, lambda c: c.set_cipher_key_file(key_file))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="encrypted"):
        serve(secret)
    state = jit.load(secret, cipher_key=key).state_dict()
    assert torch.equal(state["0.weight"], net[0].weight.detach())
