"""The port's finite sweep and state fingerprint
(paddle_tpu_torch.core.sanitizer, core.flags, ops.tree_reduce) against the
reference's `paddle_tpu.core.sanitizer` on the same numpy state: the XOR
word bit for bit and the f32 sums within 1e-6 relative for every leaf type
(f32, bf16, f16, f64, int32, int64, uint8, bool, complex64), twin leaves, a
single flipped mantissa bit and a word with its top bit set rotated
through the chain; `finite_flags`' names and flags; `select_if_finite`;
the host-side report and its error; the flag registry. The `cuda` tests
hold the multi-tensor kernel (fold and finite modes) and the Adam
kernel's check pass against these plain versions on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (the reference runs with x64 on)
from paddle_tpu.core import sanitizer as jsan
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import sanitizer as tsan
from paddle_tpu_torch.core.tree import as_tensor, flatten_with_path, tree_map
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.ops import tree_reduce as ttree
from paddle_tpu_torch.profiler.telemetry import get_telemetry
import torch_threads  # noqa: F401  (one torch thread a worker)



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

# the f32 sums: the same values summed in another order
SUM_RTOL = 1e-6


def _leaf(kind, rng, n=37):
    if kind == "float32":
        return rng.randn(n, 3).astype(np.float32)
    if kind == "bfloat16":
        return np.asarray(jnp.asarray(rng.randn(n), jnp.bfloat16))
    if kind == "float16":
        return rng.randn(n).astype(np.float16)
    if kind == "float64":
        return rng.randn(n).astype(np.float64)
    if kind == "int32":
        return rng.randint(-2**31, 2**31 - 1, (n,), dtype=np.int64) \
            .astype(np.int32)
    if kind == "int64":
        return rng.randint(-2**62, 2**62, (n,), dtype=np.int64)
    if kind == "uint8":
        return rng.randint(0, 256, (n,)).astype(np.uint8)
    if kind == "bool":
        return rng.rand(n) > 0.5
    if kind == "complex64":
        return (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    raise ValueError(kind)


KINDS = ["float32", "bfloat16", "float16", "float64", "int32", "int64",
         "uint8", "bool", "complex64"]


def _ref_fp(*trees):
    jtrees = jax.tree_util.tree_map(jnp.asarray, trees)
    fp = jax.jit(lambda t: jsan.tree_fingerprint(*t))(jtrees)
    return {k: np.asarray(v) for k, v in fp.items()}


def _port_fp(*trees):
    fp = tsan.tree_fingerprint(*tree_map(as_tensor, trees))
    return {k: v.item() for k, v in fp.items()}


def _assert_same(ref, got):
    assert got["xor"] == int(ref["xor"])
    for k in ("sum", "abs_sum"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=SUM_RTOL,
                                   atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_fold_of_each_leaf_type_matches_reference(kind):
    rng = np.random.RandomState(KINDS.index(kind))
    state = {"x": _leaf(kind, rng), "w": _leaf("float32", rng, 5)}
    ref, got = _ref_fp(state), _port_fp(state)
    assert int(ref["xor"]) != 0
    _assert_same(ref, got)


def test_fold_of_a_mixed_nested_state_matches_reference():
    rng = np.random.RandomState(1)
    state = {k: _leaf(k, rng) for k in KINDS}
    state["nested"] = {"b": _leaf("float32", rng), "a": [_leaf("int32", rng),
                                                         _leaf("bool", rng)]}
    extra = {"z": _leaf("float16", rng)}
    _assert_same(_ref_fp(state, extra), _port_fp(state, extra))


def test_twin_leaves_do_not_cancel_and_match_reference():
    rng = np.random.RandomState(2)
    a = _leaf("float32", rng)
    twins = {"a": a, "b": a.copy()}
    ref, got = _ref_fp(twins), _port_fp(twins)
    _assert_same(ref, got)
    assert got["xor"] != 0  # a plain XOR chain would give 0


def test_one_flipped_mantissa_bit_changes_the_word_not_the_sum():
    rng = np.random.RandomState(3)
    w = rng.randn(64).astype(np.float32)
    flipped = w.copy()
    flipped.view(np.uint32)[17] ^= np.uint32(1)
    a, b = _port_fp({"w": w}), _port_fp({"w": flipped})
    assert a["xor"] != b["xor"]
    assert a["xor"] ^ b["xor"] == 1  # one leaf: the flip itself
    _assert_same(_ref_fp({"w": flipped}), b)


def test_top_bit_rotates_through_the_chain_as_in_the_reference():
    # a word with its top bit set, then two more leaves: the rotate-left
    # carries bit 31 around to bit 0 and on
    state = {"a": np.array([-1], np.int32),
             "b": np.array([0x40000000, 3], np.int32),
             "c": np.array([2**31 + 5], np.int64),
             "d": np.array([1.5], np.float32)}
    ref, got = _ref_fp(state), _port_fp(state)
    _assert_same(ref, got)
    # by hand: rotl1 of the chain, then XOR the next leaf's word
    words = [0xFFFFFFFF, 0x40000000 ^ 3, (2**31 + 5) & 0xFFFFFFFF,
             int(np.float32(1.5).view(np.uint32))]
    chain = 0
    for w in words:
        chain = (((chain << 1) | (chain >> 31)) & 0xFFFFFFFF) ^ w
    assert got["xor"] == chain


def test_xor_fold_leaf_is_the_word_of_every_element():
    x = torch.tensor([1, 2, 4, 8, 2**31 - 1, -2**31], dtype=torch.int32)
    assert tsan.xor_fold_leaf(x).item() == \
        (1 ^ 2 ^ 4 ^ 8 ^ (2**31 - 1) ^ 2**31) & 0xFFFFFFFF
    assert tsan.xor_fold_leaf(torch.zeros(0)).item() == 0
    h = torch.tensor([1.0, -2.0], dtype=torch.float16)
    assert tsan.xor_fold_leaf(h).item() == int(
        np.bitwise_xor.reduce(h.numpy().view(np.uint16).astype(np.uint32)))


def test_zero_fingerprint_has_the_reference_keys():
    z = tsan.zero_fingerprint()
    assert set(z) == set(jsan.zero_fingerprint())
    assert z["sum"].dtype == torch.float32 and z["xor"].item() == 0


def _groups(rng, bad):
    g = {"fc.weight": rng.randn(4, 3).astype(np.float32),
         "fc.bias": rng.randn(3).astype(np.float32),
         "emb": np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16)),
         "steps": np.array([3], np.int32)}
    p = {k: v.copy() for k, v in g.items()}
    loss = np.float32(1.5)
    if "loss" in bad:
        loss = np.float32(np.nan)
    if "grad" in bad:
        g["fc.bias"][1] = np.inf
    if "param" in bad:
        p["emb"] = np.asarray(jnp.asarray(
            np.array([1, 2, np.nan, 4, 5], np.float32), jnp.bfloat16))
    return loss, g, p


@pytest.mark.parametrize("bad", [(), ("loss",), ("grad",), ("param",),
                                 ("grad", "param")])
def test_finite_flags_names_and_flags_match_reference(bad):
    loss, g, p = _groups(np.random.RandomState(4), bad)
    rnames, tnames = [], []
    rflags = jsan.finite_flags(rnames, loss=jnp.asarray(loss),
                               grad=jax.tree_util.tree_map(jnp.asarray, g),
                               param=jax.tree_util.tree_map(jnp.asarray, p))
    tflags_ = tsan.finite_flags(tnames, loss=as_tensor(loss),
                                grad=tree_map(as_tensor, g),
                                param=tree_map(as_tensor, p))
    assert tnames == rnames
    assert tnames[:3] == ["loss", "grad['emb']", "grad['fc.bias']"]
    assert tflags_.dtype == torch.bool
    np.testing.assert_array_equal(tflags_.numpy(), np.asarray(rflags))
    assert tsan.finite_report(tnames, tflags_) == \
        jsan.finite_report(rnames, rflags)


def test_finite_flags_of_no_float_leaf_is_none():
    names = []
    assert tsan.finite_flags(names, n={"a": torch.ones(2, dtype=torch.int32)}
                             ) is None
    assert names == []
    assert tsan.finite_report(names, None) == (True, [])


def test_select_if_finite_keeps_the_old_tree_on_a_bad_flag():
    new = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    old = {"a": torch.zeros(3), "b": [torch.full((2,), 7.0)]}
    kept = tsan.select_if_finite(torch.tensor([True, False]), new, old)
    assert torch.equal(kept["a"], old["a"])
    assert torch.equal(kept["b"][0], old["b"][0])
    took = tsan.select_if_finite(torch.tensor([True, True]), new, old)
    assert torch.equal(took["b"][0], new["b"][0])


def test_raise_if_nonfinite_names_the_leaves_the_scale_and_counts():
    tel = get_telemetry()
    before = tel.counter_value("resilience/nonfinite_steps")
    names = ["loss", "grad['w']", "param['w']"]
    with pytest.raises(FloatingPointError) as e:
        tsan.raise_if_nonfinite(names, torch.tensor([True, False, True]),
                                loss_scale=65536.0)
    msg = str(e.value)
    assert "grad['w']" in msg and "loss_scale=65536" in msg
    assert "StepGuard" in msg and "param['w']" not in msg
    assert tel.counter_value("resilience/nonfinite_steps") == before + 1
    tsan.raise_if_nonfinite(names, torch.tensor([True] * 3))  # no raise


def test_check_flag_reads_the_environment_and_set_flags(monkeypatch):
    monkeypatch.setenv("FLAGS_my_test_flag", "true")
    f = tflags.define_flag("my_test_flag", False)
    assert f.value is True
    assert tflags.get_flags("FLAGS_my_test_flag") == {
        "FLAGS_my_test_flag": True}
    assert tsan.jit_check_enabled() is False
    tflags.set_flags({"FLAGS_check_nan_inf": "1"})
    try:
        assert tsan.jit_check_enabled() is True
    finally:
        tflags.set_flags({"check_nan_inf": False})
    with pytest.raises(KeyError):
        tflags.get_flags("no_such_flag")


def test_tree_paths_are_the_reference_keystr():
    tree = {"b": [np.zeros(1), None, (np.ones(1),)], "a": {"x.y": 1.0}}
    ref = [jax.tree_util.keystr(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in flatten_with_path(tree)] == ref


def test_tree_reduce_wrappers_take_the_plain_path_on_the_cpu():
    rng = np.random.RandomState(5)
    leaves = [as_tensor(_leaf(k, rng)) for k in ("float32", "int32", "bool")]
    fp = ttree.tree_fold(leaves)
    ref = tsan.tree_fingerprint(leaves)
    assert fp["xor"].item() == ref["xor"].item()
    bad = leaves[0].clone()
    bad[0, 0] = float("inf")
    flags = ttree.tree_finite([bad, leaves[0], leaves[1]])
    assert flags.tolist() == [False, True, True]
    with pytest.raises(ValueError, match="unsupported device"):
        ttree.tree_reduce([torch.zeros(2)], "fold")


def test_adam_check_reference_flags_gradients_and_new_values():
    p = [torch.ones(4), torch.ones(3)]
    g = [torch.tensor([0.1, float("inf"), 0.2, 0.3]), torch.full((3,), 0.5)]
    m = [torch.zeros(4), torch.zeros(3)]
    v = [torch.zeros(4), torch.zeros(3)]
    pows = [[torch.ones(()) for _ in range(2)] for _ in range(2)]
    flags, ok = tfused.adam_finite_check(
        p, g, m, v, pows[0], pows[1], torch.tensor(1e-3),
        loss=torch.tensor(2.0))
    # the inf gradient's update is NaN: both its flags fall
    assert flags.tolist() == [True, False, True, False, True, True]
    assert ok.item() == 0


# -- on the card --------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_fold_matches_plain_version_and_repeats(cuda_device):
    dev = cuda_device
    rng = np.random.RandomState(6)
    leaves = [as_tensor(_leaf(k, rng, n)).to(dev)
              for k in KINDS if k != "complex64"
              for n in (1, 37, 40000)]
    leaves.append(as_tensor(_leaf("float32", rng, 40001))[1:].to(dev)
                  .contiguous()[1:])  # not 16-byte aligned
    fp = ttree.tree_reduce(leaves, "fold")
    again = ttree.tree_reduce(leaves, "fold")
    ref = tsan.tree_fingerprint(leaves)
    assert fp["xor"].item() == ref["xor"].item()
    for k in ("sum", "abs_sum"):
        assert torch.equal(fp[k], again[k])
        np.testing.assert_allclose(fp[k].item(), ref[k].item(), rtol=1e-5)


@pytest.mark.cuda
def test_cuda_finite_mode_matches_plain_version(cuda_device):
    dev = cuda_device
    leaves = [torch.randn(50000, device=dev),
              torch.randn(100, device=dev).bfloat16(),
              torch.randn(7, device=dev, dtype=torch.float64),
              torch.ones(3, dtype=torch.int32, device=dev)]
    leaves[0][49999] = float("nan")
    leaves[1][3] = float("-inf")
    got = ttree.tree_reduce(leaves, "finite")
    assert got.tolist() == [False, False, True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("master", [False, True])
def test_cuda_check_pass_matches_plain_and_gates_the_update(master,
                                                            cuda_device):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(1000,), (70000,), (0,), (3, 5)]  # an empty one too
    lowp = torch.bfloat16 if master else torch.float32
    ps = [torch.randn(*s, device=dev, generator=gen).to(lowp)
          for s in shapes]
    ms = [p.float().clone() for p in ps] if master else None
    gs = [torch.randn(*s, device=dev, generator=gen).to(lowp)
          for s in shapes]
    gs[1][123] = float("nan")
    mom = [torch.zeros(*s, device=dev) for s in shapes]
    vel = [torch.zeros(*s, device=dev) for s in shapes]
    b1 = [torch.ones((), device=dev) for _ in shapes]
    b2 = [torch.ones((), device=dev) for _ in shapes]
    lr = torch.tensor(1e-3, device=dev)
    loss = torch.tensor(1.0, device=dev)
    args = (ps, gs, mom, vel, b1, b2, lr)
    flags, ok = tfused.adam_finite_check(*args, masters=ms, loss=loss)
    ref = tfused._adam_check_reference(*args, masters=ms, loss=loss)
    assert torch.equal(flags, ref) and ok.item() == 0
    state = [t.clone() for t in [*ps, *mom, *vel, *b1, *b2,
                                 *(ms or [])]]
    check = tfused.FiniteCheck(loss, gate=True)
    tfused.fused_adam_step(*args, masters=ms, check=check)
    after = [*ps, *mom, *vel, *b1, *b2, *(ms or [])]
    assert all(torch.equal(a, b) for a, b in zip(after, state))
