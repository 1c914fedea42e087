"""Row-sparse gradients of the port (core.selected_rows, a sparse
`Embedding`, the optimizers' row paths, the sparse clips) against the
reference's `RowSparseGrad` path: every case of tests/test_sparse_grad.py,
run in both packages from the same weights and ids, the port's sparse run
also held against its own dense run where the reference's test holds its
two. `static.nn.embedding(is_sparse=True)` trains as the reference's
traced step does: with dense gradients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.selected_rows import RowSparseGrad as JRows
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core.selected_rows import RowSparseGrad
import torch_threads  # noqa: F401  (one torch thread a worker)

VOCAB, DIM = 50, 8
# f32 on both sides: the same per-row formula; duplicates and squares are
# summed in other orders
RTOL, ATOL = 1e-5, 1e-6


def _weights(seed):
    return np.random.RandomState(seed).randn(VOCAB, DIM).astype(np.float32)


def _ref_layer(w, sparse, padding_idx=None):
    e = jnn.Embedding(VOCAB, DIM, padding_idx=padding_idx, sparse=sparse)
    e.weight.set_value(w)
    return e


def _port_layer(w, sparse, padding_idx=None):
    e = tnn.Embedding(VOCAB, DIM, padding_idx=padding_idx, sparse=sparse,
                      device="cpu")
    with torch.no_grad():
        e.weight.copy_(torch.from_numpy(w))
    return e


def _ref_steps(layer, opt, batches, power=2):
    for ids in batches:
        out = layer(paddle.to_tensor(ids))
        loss = (out * out).sum() if power == 2 else out.sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return np.asarray(layer.weight.numpy())


def _port_steps(layer, opt, batches, power=2):
    for ids in batches:
        out = layer(torch.from_numpy(ids))
        loss = (out * out).sum() if power == 2 else out.sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return layer.weight.detach().numpy()


def _mods(side):
    return (jnn, jopt) if side == "ref" else (tnn, topt)


def test_backward_produces_sparse():
    e = _port_layer(_weights(0), sparse=True)
    ids = np.array([[1, 3, 3], [7, 1, 0]], np.int64)
    e(torch.from_numpy(ids)).sum().backward()
    assert e.weight.grad.is_sparse
    g = RowSparseGrad.from_coo(e.weight.grad)
    assert tuple(g.rows.shape) == (6,) and tuple(g.values.shape) == (6, DIM)
    assert g.num_rows == VOCAB
    ref = _ref_layer(_weights(0), sparse=True)
    ref(paddle.to_tensor(ids)).sum().backward()
    assert isinstance(ref.weight.grad, JRows)
    assert ref.weight.grad.rows.shape == tuple(g.rows.shape)


def test_to_dense_matches_dense_grad():
    ids = np.array([[1, 3, 3], [7, 1, 0]], np.int64)
    grads = {}
    for name, sparse in (("sparse", True), ("dense", False)):
        e = _port_layer(_weights(0), sparse)
        out = e(torch.from_numpy(ids))
        (out * out).sum().backward()
        g = e.weight.grad
        grads[name] = (RowSparseGrad.from_coo(g).to_dense() if sparse
                       else g).numpy()
    ref = _ref_layer(_weights(0), sparse=True)
    out = ref(paddle.to_tensor(ids))
    (out * out).sum().backward()
    want = np.asarray(ref.weight.grad.to_dense())
    for got in grads.values():
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_merged_combines_duplicates():
    rows = np.array([3, 1, 3, 9], np.int64)
    vals = np.arange(8, dtype=np.float32).reshape(4, 2)
    g = RowSparseGrad(torch.from_numpy(rows), torch.from_numpy(vals), 10)
    m = g.merged()
    np.testing.assert_array_equal(m.to_dense().numpy(), g.to_dense().numpy())
    real = m.rows.tolist()
    assert len(real) == len(set(real))
    ref = JRows(jnp.asarray(rows, jnp.int32), jnp.asarray(vals), 10)
    np.testing.assert_array_equal(m.to_dense().numpy(),
                                  np.asarray(ref.merged().to_dense()))
    # padding (a row outside [0, num_rows)) is dropped everywhere
    pad = RowSparseGrad(torch.tensor([2, 10, 2]), torch.ones(3, 2), 10)
    jpad = JRows(jnp.asarray([2, 10, 2], jnp.int32), jnp.ones((3, 2)), 10)
    np.testing.assert_array_equal(pad.to_dense().numpy(),
                                  np.asarray(jpad.to_dense()))
    assert float(pad.sq_l2norm()) == float(jpad.sq_l2norm()) == 8.0
    # + : sparse + sparse concatenates, sparse + dense densifies
    both = g + pad
    assert isinstance(both, RowSparseGrad) and both.rows.numel() == 7
    dense = g + torch.ones(10, 2)
    np.testing.assert_array_equal(dense.numpy(),
                                  g.to_dense().numpy() + 1.0)
    np.testing.assert_array_equal(g.scale(0.5).to_dense().numpy(),
                                  np.asarray(ref.scale(0.5).to_dense()))


@pytest.mark.parametrize("opt_name", ["SGD", "Adam", "AdamW"])
def test_sparse_matches_dense_training(opt_name):
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, VOCAB, (4, 6)).astype(np.int64)
               for _ in range(4)]
    kw = {"weight_decay": 0.0} if opt_name == "AdamW" else {}
    out = {}
    for side, sparse in (("ref", True), ("port", True), ("port_dense", False)):
        mk = getattr(_mods("ref" if side == "ref" else "port")[1], opt_name)
        if side == "ref":
            e = _ref_layer(_weights(0), sparse)
            out[side] = _ref_steps(e, mk(learning_rate=0.1,
                                         parameters=e.parameters(), **kw),
                                   batches)
        else:
            e = _port_layer(_weights(0), sparse)
            out[side] = _port_steps(e, mk(learning_rate=0.1,
                                          parameters=e.parameters(), **kw),
                                    batches)
    np.testing.assert_allclose(out["port"], out["ref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["port"], out["port_dense"], rtol=RTOL,
                               atol=ATOL)


def test_adam_moments_touch_only_rows():
    """Lazy mode: untouched rows keep their (zero) moments and their
    values, as in the reference."""
    ids = np.array([[2, 5]], np.int64)
    e = _port_layer(_weights(0), sparse=True)
    opt = topt.Adam(learning_rate=0.1, lazy_mode=True,
                    parameters=e.parameters())
    e(torch.from_numpy(ids)).sum().backward()
    opt.step()
    m1 = opt._accumulators[id(e.weight)]["moment1"].numpy()
    untouched = [i for i in range(VOCAB) if i not in (2, 5)]
    assert np.abs(m1[untouched]).max() == 0.0
    assert np.abs(m1[[2, 5]]).max() > 0.0
    assert np.array_equal(e.weight.detach().numpy()[untouched],
                          _weights(0)[untouched])
    ref = _ref_layer(_weights(0), sparse=True)
    ropt = jopt.Adam(learning_rate=0.1, lazy_mode=True,
                     parameters=ref.parameters())
    ref(paddle.to_tensor(ids)).sum().backward()
    ropt.step()
    np.testing.assert_allclose(
        m1, np.asarray(ropt._accumulators[id(ref.weight)]["moment1"]),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(e.weight.detach().numpy(),
                               np.asarray(ref.weight.numpy()), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("opt_name", ["Adam", "AdamW"])
def test_lazy_mode_matches_the_reference_over_steps(opt_name):
    rng = np.random.RandomState(3)
    batches = [rng.randint(0, VOCAB, (3, 5)).astype(np.int64)
               for _ in range(3)]
    kw = dict(learning_rate=0.05, lazy_mode=True)
    if opt_name == "AdamW":
        kw["weight_decay"] = 0.1
    e = _port_layer(_weights(2), sparse=True)
    got = _port_steps(e, getattr(topt, opt_name)(parameters=e.parameters(),
                                                 **kw), batches)
    r = _ref_layer(_weights(2), sparse=True)
    want = _ref_steps(r, getattr(jopt, opt_name)(parameters=r.parameters(),
                                                 **kw), batches)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_weight_decay_falls_back_dense_correctly():
    rng = np.random.RandomState(1)
    batches = [rng.randint(0, VOCAB, (3, 4)).astype(np.int64)
               for _ in range(2)]
    out = {}
    for side, sparse in (("ref", True), ("port", True), ("port_dense", False)):
        if side == "ref":
            e = _ref_layer(_weights(0), sparse)
            out[side] = _ref_steps(e, jopt.Adam(
                learning_rate=0.1, weight_decay=0.01,
                parameters=e.parameters()), batches)
        else:
            e = _port_layer(_weights(0), sparse)
            out[side] = _port_steps(e, topt.Adam(
                learning_rate=0.1, weight_decay=0.01,
                parameters=e.parameters()), batches)
    np.testing.assert_allclose(out["port"], out["ref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["port"], out["port_dense"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("clip_name", ["ClipGradByGlobalNorm",
                                       "ClipGradByValue", "ClipGradByNorm"])
@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_clips_with_sparse(clip_name, opt_name):
    """The reference's `test_global_norm_clip_with_sparse` and
    `test_other_clips_with_sparse`, with Adam's row path as well."""
    ids = np.array([[1, 1, 4]], np.int64)
    out = {}
    for side, sparse in (("ref", True), ("port", True), ("port_dense", False)):
        nn_mod, opt_mod = _mods("ref" if side == "ref" else "port")
        clip = getattr(nn_mod, clip_name)(0.01)
        if side == "ref":
            e = _ref_layer(_weights(6), sparse)
            out[side] = _ref_steps(e, getattr(opt_mod, opt_name)(
                learning_rate=0.5, grad_clip=clip,
                parameters=e.parameters()), [ids])
        else:
            e = _port_layer(_weights(6), sparse)
            out[side] = _port_steps(e, getattr(opt_mod, opt_name)(
                learning_rate=0.5, grad_clip=clip,
                parameters=e.parameters()), [ids])
    np.testing.assert_allclose(out["port"], out["ref"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["port"], out["port_dense"], rtol=RTOL,
                               atol=ATOL)


def test_global_clip_over_sparse_and_dense_gradients():
    """One global norm over a sparse table and a dense layer: the dense
    part through the sum-of-squares pass, as the reference sums both."""
    ids = np.array([[1, 1, 4, 9]], np.int64)
    lin = np.random.RandomState(4).randn(DIM, 3).astype(np.float32)
    res = {}
    for side in ("ref", "port"):
        nn_mod, opt_mod = _mods(side)
        if side == "ref":
            e = _ref_layer(_weights(5), True)
            fc = jnn.Linear(DIM, 3)
            fc.weight.set_value(lin)
            x = e(paddle.to_tensor(ids))
        else:
            e = _port_layer(_weights(5), True)
            fc = tnn.Linear(DIM, 3, device="cpu")
            with torch.no_grad():
                fc.weight.copy_(torch.from_numpy(lin))
            x = e(torch.from_numpy(ids))
        opt = opt_mod.Adam(learning_rate=0.1,
                           grad_clip=nn_mod.ClipGradByGlobalNorm(0.05),
                           parameters=[*e.parameters(), *fc.parameters()])
        (fc(x) ** 2).sum().backward()
        opt.step()
        res[side] = [np.asarray(t.numpy() if side == "ref"
                                else t.detach().numpy())
                     for t in (e.weight, fc.weight, fc.bias)]
    for got, want in zip(res["port"], res["ref"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_padding_idx_rows_not_updated():
    ids = np.array([[0, 1, 2]], np.int64)
    e = _port_layer(_weights(3), sparse=True, padding_idx=0)
    before = e.weight.detach().numpy()[0].copy()
    opt = topt.SGD(learning_rate=1.0, parameters=e.parameters())
    out = e(torch.from_numpy(ids))
    assert float(out[0, 0].detach().abs().sum()) == 0.0  # padding gives 0
    out.sum().backward()
    opt.step()
    np.testing.assert_array_equal(e.weight.detach().numpy()[0], before)
    ref = _ref_layer(_weights(3), sparse=True, padding_idx=0)
    ropt = jopt.SGD(learning_rate=1.0, parameters=ref.parameters())
    ref(paddle.to_tensor(ids)).sum().backward()
    ropt.step()
    np.testing.assert_allclose(e.weight.detach().numpy(),
                               np.asarray(ref.weight.numpy()), rtol=RTOL,
                               atol=ATOL)


def test_accumulation_two_backwards():
    grads = {}
    for name, sparse in (("sparse", True), ("dense", False)):
        e = _port_layer(_weights(0), sparse)
        for ids in (np.array([[1, 2]], np.int64),
                    np.array([[2, 3]], np.int64)):
            e(torch.from_numpy(ids)).sum().backward()
        g = e.weight.grad
        grads[name] = (RowSparseGrad.from_coo(g).to_dense() if sparse
                       else g).numpy()
    ref = _ref_layer(_weights(0), sparse=True)
    for ids in (np.array([[1, 2]], np.int64), np.array([[2, 3]], np.int64)):
        ref(paddle.to_tensor(ids)).sum().backward()
    want = np.asarray(ref.weight.grad.to_dense())
    for got in grads.values():
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dense_then_sparse_accumulation_tied_use():
    """A table used densely (a product) AND as a lookup in one graph: the
    two gradients combine into a dense one, as in the reference."""
    ids = np.array([[1, 2, 3]], np.int64)
    got = {}
    for name, sparse in (("sparse", True), ("dense", False)):
        e = _port_layer(_weights(5), sparse)
        emb = e(torch.from_numpy(ids))
        (emb.sum() + (e.weight * 0.5).sum()).backward()
        assert not e.weight.grad.is_sparse
        got[name] = e.weight.grad.numpy()
    ref = _ref_layer(_weights(5), sparse=True)
    emb = ref(paddle.to_tensor(ids))
    (emb.sum() + (ref.weight * 0.5).sum()).backward()
    assert not isinstance(ref.weight.grad, JRows)
    for g in got.values():
        np.testing.assert_allclose(g, ref.weight.grad.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_global_norm_clip_ignores_padding_rows():
    ids = np.array([[0, 1, 2]], np.int64)
    e = _port_layer(_weights(8), sparse=True, padding_idx=0)
    (e(torch.from_numpy(ids)) * 3.0).sum().backward()
    sq = float(RowSparseGrad.from_coo(e.weight.grad).sq_l2norm())
    d = _port_layer(_weights(8), sparse=False, padding_idx=0)
    (d(torch.from_numpy(ids)) * 3.0).sum().backward()
    sq_dense = float((d.weight.grad.numpy().astype(np.float64) ** 2).sum())
    ref = _ref_layer(_weights(8), sparse=True, padding_idx=0)
    (ref(paddle.to_tensor(ids)) * 3.0).sum().backward()
    sq_ref = float(np.asarray(ref.weight.grad.sq_l2norm()))
    np.testing.assert_allclose(sq, sq_dense, rtol=1e-5)
    np.testing.assert_allclose(sq, sq_ref, rtol=1e-5)


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_sparse_master_weights_update_the_master_rows(opt_name):
    """A bf16 table with an f32 master: the row update runs on the master
    and its rows are re-cast, as the reference's `_MasterView` path."""
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, VOCAB, (2, 5)).astype(np.int64)
               for _ in range(2)]
    w = _weights(9)
    e = _port_layer(w, sparse=True)
    e.weight.data = e.weight.data.to(torch.bfloat16)
    opt = getattr(topt, opt_name)(learning_rate=0.1, multi_precision=True,
                                  parameters=e.parameters())
    for ids in batches:
        (e(torch.from_numpy(ids)).float() ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
    master = opt._accumulators[id(e.weight)]["master"]
    assert master.dtype == torch.float32
    assert torch.equal(e.weight.detach(), master.to(torch.bfloat16))
    r = _ref_layer(w, sparse=True)
    r.weight._value = r.weight._value.astype(jnp.bfloat16)
    ropt = getattr(jopt, opt_name)(learning_rate=0.1, multi_precision=True,
                                   parameters=r.parameters())
    for ids in batches:
        (r(paddle.to_tensor(ids)).astype("float32") ** 2).sum().backward()
        ropt.step()
        ropt.clear_grad()
    want = np.asarray(ropt._accumulators[id(r.weight)]["master"])
    # the lookups' gradients are bf16 on both sides: the masters agree to
    # a bf16 gradient rounding of the step
    np.testing.assert_allclose(master.numpy(), want, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("fn", ["embedding", "sparse_embedding"])
def test_static_embedding_is_sparse_trains_as_the_reference(fn):
    """`static.nn.embedding(is_sparse=True)` (and `sparse_embedding`) in
    a Program stepped by Adam(lazy_mode=True): the Executor densifies, as
    the reference's traced step has dense gradients, so the runs give the
    reference's dense Adam steps. (The reference's own Program gathers
    with the ids placeholder's record-time zeros, see
    test_torch_static.py's REF_NN_DIFFERS, so its eager layer is the
    yardstick.)"""
    w = _weights(11)
    ids = np.array([[1, 4, 4, 7]], np.int64)
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("ids", [1, 4], "int64", device="cpu")
        attr = tnn.ParamAttr(name="emb")
        kw = {"is_sparse": True} if fn == "embedding" else {}
        out = getattr(tstatic.nn, fn)(x, [VOCAB, DIM], param_attr=attr,
                                      **kw)
        loss = (out * out).sum()
        topt.Adam(learning_rate=0.1, lazy_mode=True).minimize(loss)
    tstatic.set_program_state(main, {"emb": w})
    exe = tstatic.Executor(tstatic.CPUPlace())
    for _ in range(2):
        exe.run(main, feed={"ids": ids}, fetch_list=[loss])
    got = main.all_parameters()[0].detach().numpy()
    ref = _ref_layer(w, sparse=False)
    want = _ref_steps(ref, jopt.Adam(learning_rate=0.1,
                                     parameters=ref.parameters()),
                      [ids, ids])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the same program eagerly, its row path lazy: only rows 1, 4, 7 move
    e = _port_layer(w, sparse=True)
    _port_steps(e, topt.Adam(learning_rate=0.1, lazy_mode=True,
                             parameters=e.parameters()), [ids, ids])
    moved = np.flatnonzero((e.weight.detach().numpy() != w).any(1))
    assert moved.tolist() == [1, 4, 7]
