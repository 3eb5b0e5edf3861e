"""Port parity: the fused vocab projection + cross-entropy.

The same numpy inputs go through the JAX package's ``fused_linear_xent``
(its Pallas kernels in interpret mode, as ``tests/test_fused_xent.py`` runs
them) and the port's, whose CPU tensors take the plain versions the CUDA
kernels are held against on the card. fp32 unless a test says otherwise;
each test states its tolerance.
"""

import ctypes
import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.ops.pallas.fused_xent import fused_linear_xent as jfused
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import fused_xent as tfx
from deepspeed_tpu_torch.ops import optimizers as topt


def _inputs(N, D, V, seed, ignore_every, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((N, D)) * 0.3).astype(dtype)
    w = (rng.standard_normal((D, V)) * 0.1).astype(dtype)
    y = rng.integers(0, V, N).astype(np.int32)
    y[::ignore_every] = -1
    return h, w, y


def _masked_mean(nll, y):
    mask = (y >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


@pytest.mark.parametrize("vocab", [512, 777])  # 777: the ragged last vocab block
def test_forward_matches_pallas(vocab):
    """nll of every row, ignored rows included (lse − 0 in both); the
    tolerance of tests/test_fused_xent.py:38 (fp32, summation order)."""
    h, w, y = _inputs(256, 128, vocab, seed=0, ignore_every=7)
    ref = np.asarray(jfused(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), block_rows=128, block_v=128,
                            interpret=True))
    nll = tfx.fused_linear_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y),
                                block_rows=128, block_v=128)
    assert nll.dtype == torch.float32 and nll.shape == (256,)
    np.testing.assert_allclose(nll.numpy(), ref, rtol=2e-5, atol=2e-5)
    plain, lse = tfx.fused_linear_xent_reference(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y))
    torch.testing.assert_close(plain, nll, rtol=0, atol=0)
    np.testing.assert_allclose(lse.numpy()[::7], ref[::7], rtol=2e-5, atol=2e-5)


def test_gradients_match_pallas():
    """dH and dW through the autograd Function vs jax.grad through the
    Pallas kernels, with the tolerances of tests/test_fused_xent.py:61-63;
    ignored rows get exactly zero hidden-gradient."""
    h, w, y = _inputs(256, 128, 640, seed=3, ignore_every=5)

    def jloss(h, w):
        nll = jfused(h, w, jnp.asarray(y), block_rows=128, block_v=128, interpret=True)
        mask = (jnp.asarray(y) >= 0).astype(jnp.float32)
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    jl, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
    loss = _masked_mean(tfx.fused_linear_xent(th, tw, torch.from_numpy(y), block_rows=128, block_v=128),
                        torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-5)
    assert np.abs(th.grad.numpy()[::5]).max() == 0.0


def test_bf16_backward_rounds_ds_where_pallas_does():
    """bf16 inputs: the plain backward rounds ds to bf16 before each product,
    as the Pallas kernels do, so both give the same bf16 gradients up to
    summation order: within 1% of the largest value (about two bf16 ulps)."""
    h, w, y = _inputs(256, 64, 384, seed=4, ignore_every=6)
    hb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (h, w))

    def jloss(h, w):
        nll = jfused(h, w, jnp.asarray(y), block_rows=128, block_v=128, interpret=True)
        mask = (jnp.asarray(y) >= 0).astype(jnp.float32)
        return jnp.sum(nll * mask) / jnp.sum(mask)

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(hb, wb)
    th, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16().requires_grad_(True)
              for a in (hb, wb))
    _masked_mean(tfx.fused_linear_xent(th, tw, torch.from_numpy(y)), torch.from_numpy(y)).backward()
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    for port, ref in ((th.grad, jdh), (tw.grad, jdw)):
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(port.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-2, err


@pytest.mark.parametrize("N,D,V,kw", [
    (100, 32, 256, {}),                     # auto block_rows = 100: not a multiple of 8
    (256, 32, 256, {"block_rows": 96}),     # 256 rows not divisible by 96
    (256, 32, 256, {"block_v": 100}),       # block_v not 128-aligned
    (24, 16, 130, {"block_rows": 8}),       # accepted
])
def test_argument_rules_match_jax(N, D, V, kw):
    h, w, y = _inputs(N, D, V, seed=5, ignore_every=4)
    try:
        ref = jfused(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), interpret=True, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0].split(" must")[0]):
            tfx.fused_linear_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), **kw)
        return
    out = tfx.fused_linear_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.fixture
def no_jax_mesh():
    """effective_loss_impl reads the JAX package's active mesh; these tests
    compare the one-device predicate, so none is active."""
    saved = jtfm._ACTIVE_MESH[0]
    jtfm._ACTIVE_MESH[0] = None
    yield
    jtfm._ACTIVE_MESH[0] = saved


def test_effective_loss_impl_matches_jax(no_jax_mesh):
    base = dict(vocab_size=97, max_seq_len=64, num_layers=1, num_heads=2, hidden_size=32)
    cases = [("chunked", 0, 0)] + [("fused_xent", br, bv) for br in (0, 96, 128, 256) for bv in (0, 128, 200)]
    for impl, br, bv in cases:
        kw = dict(base, loss_impl=impl, loss_fused_block_rows=br, loss_fused_block_v=bv)
        jcfg, tcfg = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
        for n_rows in (None, 128, 200, 256, 384, 512, 1000, 16384):
            assert ttfm.effective_loss_impl(tcfg, n_rows=n_rows) == jtfm.effective_loss_impl(jcfg, n_rows=n_rows), \
                (impl, br, bv, n_rows)


def _models(**kw):
    base = dict(vocab_size=777, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=128, loss_chunk_size=64)
    jparams = jax.tree.map(np.asarray, jtfm.Model(jtfm.TransformerConfig(**base)).init(jax.random.PRNGKey(0)))
    return (jtfm.TransformerConfig(**base, **kw), ttfm.TransformerConfig(**base, **kw), jparams)


def test_model_loss_and_gradients_match_jax(no_jax_mesh):
    """TransformerConfig(loss_impl='fused_xent')'s loss and parameter
    gradients vs the JAX model's (tests/test_fused_xent.py:139): 256 rows
    take the fused path in both (a fallback warning is an error here).
    fp32 through two layers: loss 1e-5, gradients rtol 5e-4 / atol 5e-5 as
    tests/test_torch_training.py holds the chunked loss. The port's fused
    loss also equals its chunked loss (1e-5)."""
    fused = dict(loss_impl="fused_xent", loss_fused_block_rows=128, loss_fused_block_v=128)
    jcfg, tcfg, jparams = _models(**fused)
    toks = np.random.default_rng(1).integers(0, 777, size=(2, 129)).astype(np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jl, jg = jax.value_and_grad(lambda p: jtfm.causal_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}))(
            jax.tree.map(jnp.asarray, jparams))
        tp = topt.tree_map(lambda t: t.requires_grad_(True), interop.params_from_jax(jparams))
        tl = ttfm.causal_lm_loss(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, ref in jflat:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5,
                                   err_msg=jax.tree_util.keystr(path))
    chunked = ttfm.causal_lm_loss(tcfg.replace(loss_impl="chunked"), interop.params_from_jax(jparams),
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(chunked.item(), tl.item(), rtol=1e-5)


def test_unaligned_rows_warn_and_fall_back_like_jax(no_jax_mesh):
    """200 rows are not 128-aligned: both packages warn and take the chunked
    loss, so the port's fused config gives its chunked loss exactly."""
    fused = dict(loss_impl="fused_xent", loss_fused_block_rows=128, loss_fused_block_v=128)
    jcfg, tcfg, jparams = _models(**fused)
    toks = np.random.default_rng(2).integers(0, 777, size=(2, 101)).astype(np.int32)
    with pytest.warns(UserWarning, match="falling back to the chunked loss"):
        jtfm.causal_lm_loss(jcfg, jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(toks)})
    tparams = interop.params_from_jax(jparams)
    with pytest.warns(UserWarning, match="falling back to the chunked loss"):
        tl = ttfm.causal_lm_loss(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    chunked = ttfm.causal_lm_loss(tcfg.replace(loss_impl="chunked"), tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.item() == chunked.item()


_COUNTERS = (tfx.fused_xent_forward, tfx.xent_ds_pass, tfx.xent_dw_pass, tfx.xent_dh_pass)


def test_cpu_tensors_count_no_launch_and_kernel_entry_points_need_cuda():
    """CPU tensors take the plain versions through autograd and launch
    nothing; the two CUDA entry points refuse CPU tensors."""
    h, w, y = (torch.from_numpy(a) for a in _inputs(128, 16, 200, seed=6, ignore_every=3))
    before = [c.launches for c in _COUNTERS]
    h.requires_grad_(True)
    _masked_mean(tfx.fused_linear_xent(h, w, y), y).backward()
    assert [c.launches for c in _COUNTERS] == before
    with pytest.raises(ValueError, match="CUDA"):
        tfx.fused_xent_forward(h.detach(), w, y)
    _, lse = tfx.fused_linear_xent_reference(h.detach(), w, y)
    with pytest.raises(ValueError, match="CUDA"):
        tfx.fused_xent_backward(h.detach(), w, y, lse, torch.ones(128))
    assert [c.launches for c in _COUNTERS] == before


@pytest.mark.parametrize("N,V,itemsize", [
    (16384, 50304, 2),   # the training shape: 8192 columns, 7 chunks, the last 1152 wide
    (16384, 50304, 4),   # fp32: 4096 columns
    (2048, 50304, 2),    # one chunk: the whole vocab rounded up to a tile
    (3000, 777, 2),      # a vocab below one tile's multiple
    (1 << 21, 1000, 2),  # rows so many that even one tile exceeds the budget: one tile
])
def test_backward_chunk_rule(N, V, itemsize):
    """Chunks are whole tiles, keep the ds scratch within 256 MiB (unless one
    tile alone exceeds it), never exceed the vocab rounded up to a tile, and
    cover [0, V) exactly and in order with only the last one ragged."""
    chunk = tfx.backward_chunk(N, V, itemsize)
    assert chunk % tfx.TILE == 0 and chunk <= -(-V // tfx.TILE) * tfx.TILE
    assert N * chunk * itemsize <= tfx.SCRATCH_BYTES or chunk == tfx.TILE
    if N * (chunk + tfx.TILE) * itemsize <= tfx.SCRATCH_BYTES:  # the largest that fits
        assert chunk + tfx.TILE > -(-V // tfx.TILE) * tfx.TILE
    chunks = tfx.vocab_chunks(V, chunk)
    assert chunks[0][0] == 0 and sum(w for _, w in chunks) == V
    assert all(a + w == b for (a, w), (b, _) in zip(chunks, chunks[1:]))
    assert all(w == chunk for _, w in chunks[:-1]) and 0 < chunks[-1][1] <= chunk
    if (N, itemsize) == (16384, 2):
        assert chunk == 8192 and len(chunks) == 7 and chunks[-1] == (49152, 1152)


@pytest.mark.parametrize("vocab", [127, 129])  # one column short of, and one past, a 128-column chunk
@pytest.mark.parametrize("tied", [True, False])
def test_plain_backward_at_chunk_edges_matches_pallas(vocab, tied):
    """The plain backward over explicit 128-column chunks (what the kernels
    do per chunk) vs jax.grad through the Pallas kernels in interpret mode,
    ignored rows included, with the head tied (the transpose of a [V, D]
    buffer) or untied; fp32 with the tolerances of test_gradients_match_pallas."""
    h, w, y = _inputs(256, 64, vocab, seed=7, ignore_every=5)
    mask = (y >= 0).astype(np.float32)
    g = mask / mask.sum()

    def jloss(h, w):
        nll = jfused(h, w, jnp.asarray(y), block_rows=128, block_v=128, interpret=True)
        return jnp.sum(nll * jnp.asarray(mask)) / jnp.sum(jnp.asarray(mask))

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    head = torch.from_numpy(np.ascontiguousarray(w.T)).t() if tied else torch.from_numpy(w)
    th, ty = torch.from_numpy(h), torch.from_numpy(y)
    _, lse = tfx.fused_linear_xent_reference(th, head, ty)
    dh, dw = tfx.fused_linear_xent_backward_reference(th, head, ty, lse, torch.from_numpy(g), chunk=128)
    assert len(tfx.vocab_chunks(vocab, 128)) == (1 if vocab < 128 else 2)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4, atol=1e-5)
    assert np.abs(dh.numpy()[::5]).max() == 0.0


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const float*": ctypes.c_void_p, "const int*": ctypes.c_void_p, "int": ctypes.c_int}


def test_params_struct_mirrors_the_kernels_xent_params():
    """The ctypes block the wrapper fills is ``XentParams`` as
    ``csrc/fused_xent.cu`` declares it: same fields, order and types."""
    src = (Path(tfx.__file__).resolve().parents[1] / "csrc" / "fused_xent.cu").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct XentParams \{(.*?)\n\};", src, re.S).group(1))
    theirs = []
    for decl in (d.strip() for d in body.split(";")):
        if not decl:
            continue
        m = re.match(r"((?:const )?(?:void|float|int|long long)\*?)\s+(.*)", decl)
        for name in (n.strip() for n in m.group(2).split(",")):
            arr = re.match(r"(\w+)\[(\d+)\]", name)
            if arr:
                assert m.group(1) == "long long"
                theirs.append((arr.group(1), ctypes.c_longlong * int(arr.group(2))))
            else:
                theirs.append((name, _CTYPES[m.group(1)]))
    assert [name for name, _ in tfx._Params._fields_] == [name for name, _ in theirs]
    for (name, ours), (_, want) in zip(tfx._Params._fields_, theirs):
        assert ctypes.sizeof(ours) == ctypes.sizeof(want), name
        assert getattr(ours, "_type_", ours) == getattr(want, "_type_", want), name
    assert len(theirs) == 11 + 4 + 7


def test_tma_operands_pad_only_what_tma_cannot_read():
    """16-bit hidden and head reach the backward kernels where they lie when
    TMA can read them (a unit stride, a 16-byte base, the other stride a
    multiple of 8); otherwise as padded copies with the same values, shape
    and layout."""
    h = torch.randn(64, 768).bfloat16()
    wte = torch.randn(304, 768).bfloat16()
    for head in (wte.t(), wte.t().contiguous()):  # tied, untied [D, V]: rows of 1536 and 608 bytes
        got_h, got_w = tfx.tma_operands(h, head)
        assert got_h is h and got_w is head
    h70, wte70 = torch.randn(64, 70).bfloat16(), torch.randn(301, 70).bfloat16()
    for head in (wte70.t(), wte70.t().contiguous()):  # rows of 140 and 602 bytes
        got_h, got_w = tfx.tma_operands(h70, head)
        assert tfx.tma_readable(got_h) and tfx.tma_readable(got_w)
        assert torch.equal(got_h, h70) and torch.equal(got_w, head)
        assert got_h.stride(1) == 1 and (got_w.stride(0) == 1) == (head.stride(0) == 1)
    wide = torch.randn(64, 776).bfloat16()
    assert not tfx.tma_readable(wide[:, 1:769])  # base off 16 bytes
    assert tfx.tma_readable(wide[:, 8:776])
    got_h, _ = tfx.tma_operands(h.t().contiguous().t(), wte.t())  # hidden column-major
    assert got_h.stride(1) == 1 and torch.equal(got_h, h)


def test_backward_launches_three_kernels_per_chunk_in_order(monkeypatch):
    """``fused_xent_backward`` launches the ds pass, the dW product and the
    dH product for each vocab chunk in order, each counted once, on a
    parameter block over TMA-readable operands, a [N, chunk] ds scratch and,
    with more than one chunk, an fp32 [N, D] dH accumulator. The launch is
    stubbed: what is checked is what would reach the kernels."""
    seen = []

    def params(h, w, y, **tensors):
        seen.append(dict(h=h, w=w, **tensors))
        return tfx._Params()

    monkeypatch.setattr(tfx, "_params", params)
    monkeypatch.setattr(tfx, "_launch", lambda name, p, device: seen.append((name, p.v0, p.vc)))
    for c in _COUNTERS:
        monkeypatch.setattr(c, "launches", 0)
    N, D, V = 64, 70, 300
    monkeypatch.setattr(tfx, "SCRATCH_BYTES", N * 2 * 256)  # a 256-column chunk
    h = torch.zeros(N, D, dtype=torch.bfloat16)
    head = torch.zeros(V, D, dtype=torch.bfloat16).t()
    y, lse, g = torch.zeros(N, dtype=torch.int32), torch.zeros(N), torch.zeros(N)
    dh, dw = tfx.fused_xent_backward(h, head, y, lse, g)
    chunks = tfx.vocab_chunks(V, 256)
    assert chunks == [(0, 256), (256, 44)]
    names = ("dstt_xent_bwd_ds", "dstt_xent_bwd_dw", "dstt_xent_bwd_dh")
    assert seen[1:] == [(n, v0, vc) for v0, vc in chunks for n in names]
    given = seen[0]
    assert tfx.tma_readable(given["h"]) and tfx.tma_readable(given["w"]) and given["w"].stride(0) == 1
    assert given["ds"].shape == (N, 256) and given["dh_acc"].shape == (N, D)
    assert given["dh_acc"].dtype == torch.float32 and given["dh"] is dh and given["dw"] is dw
    assert dh.is_contiguous() and dw.shape == head.shape and dw.stride() == head.stride()
    assert [c.launches for c in _COUNTERS] == [0] + [len(chunks)] * 3


@pytest.mark.parametrize("which", [0, 1, 2])  # the ds pass, the dW product, the dH product
def test_backward_passes_subset_runs_one_kernel_over_every_chunk(monkeypatch, which):
    """``passes`` (one kernel alone, for timing it) launches only that kernel,
    once for each vocab chunk in order, and counts only it. The launch is
    stubbed as in the test above."""
    seen = []
    monkeypatch.setattr(tfx, "_params", lambda h, w, y, **tensors: tfx._Params())
    monkeypatch.setattr(tfx, "_launch", lambda name, p, device: seen.append((name, p.v0, p.vc)))
    for c in _COUNTERS:
        monkeypatch.setattr(c, "launches", 0)
    N, D, V = 64, 64, 600
    monkeypatch.setattr(tfx, "SCRATCH_BYTES", N * 2 * 256)  # 256-column chunks: 256, 256, 88
    launch = tfx.BACKWARD_PASSES[which]
    h, head = torch.zeros(N, D, dtype=torch.bfloat16), torch.zeros(D, V, dtype=torch.bfloat16)
    y, lse, g = torch.zeros(N, dtype=torch.int32), torch.zeros(N), torch.zeros(N)
    tfx.fused_xent_backward(h, head, y, lse, g, passes=(launch,))
    name = ("dstt_xent_bwd_ds", "dstt_xent_bwd_dw", "dstt_xent_bwd_dh")[which]
    assert seen == [(name, 0, 256), (name, 256, 256), (name, 512, 88)]
    assert [c.launches for c in _COUNTERS[1:]] == [3 if i == which else 0 for i in range(3)]
