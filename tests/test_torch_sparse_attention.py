"""Port parity: block-sparse attention, the curriculum and the dataloader.

The same numpy inputs go through the JAX package (its Pallas sparse kernels
in interpret mode, as ``tests/test_sparse_attention.py`` runs them on the
CPU) and the port on CPU tensors, which takes the plain versions the CUDA
kernels are held against on the card. Layouts and lists are compared
exactly; attention in fp32 with the flash port's tolerance (rtol 1e-4,
atol 1e-5: summation order only); the model and the engine with the
tolerances of ``tests/test_torch_training.py``.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention import kernels as jsk
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime.data_pipeline import curriculum_scheduler as jcs
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import kernels as tsk
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime.data_pipeline import curriculum_scheduler as tcs
from simple_model import base_config, tiny_transformer
from test_torch_training import _leaves, _models

RTOL, ATOL = 1e-4, 1e-5  # fp32, summation order only

MODES = {
    "fixed": {"num_local_blocks": 4, "num_global_blocks": 1},
    "fixed_multi": {"num_local_blocks": 4, "num_global_blocks": 2, "different_layout_per_head": True,
                    "num_different_global_patterns": 2, "horizontal_global_attention": True},
    "fixed_uni": {"num_local_blocks": 2, "attention": "unidirectional"},
    "bigbird": {"num_random_blocks": 2, "num_sliding_window_blocks": 3, "num_global_blocks": 1},
    "bigbird_per_head": {"num_random_blocks": 1, "different_layout_per_head": True},
    "bslongformer": {"num_sliding_window_blocks": 3, "global_block_indices": [0, 5],
                     "global_block_end_indices": [2, 6]},
    "variable": {"local_window_blocks": [1, 2, 3], "global_block_indices": [0], "num_random_blocks": 2},
    "variable_uni": {"local_window_blocks": [2], "num_random_blocks": 1, "attention": "unidirectional",
                     "horizontal_global_attention": False},
    "dense": {},
}


def _config(pkg, name, seed=0, H=3, block=16):
    kw = dict(MODES[name])
    mode = name.split("_")[0]
    if mode in ("bigbird", "variable"):
        kw["seed"] = seed
    return pkg.SPARSITY_CONFIGS[mode](num_heads=H, block=block, **kw)


@pytest.mark.parametrize("S", [128, 256, 336])
@pytest.mark.parametrize("name", list(MODES))
def test_layouts_equal_jax_bit_for_bit(name, S):
    for seed in (0, 1, 7):
        ref = _config(jsa, name, seed).make_layout(S)
        got = _config(tsa, name, seed).make_layout(S)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["fixed", "bigbird", "bslongformer", "variable", "dense"])
def test_layout_to_lists_identical(name, causal):
    layout = _config(jsa, name, seed=3).make_layout(256)[0]
    for ref, got in zip(jsk.layout_to_lists(layout, causal), tsk.layout_to_lists(layout, causal)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    empty = np.zeros((2, 2), np.int64)
    empty[0, 0] = 1
    with pytest.raises(ValueError, match="no keys"):
        tsk.layout_to_lists(empty, causal=True)


def test_device_lists_are_cached_per_length_layout_and_causality():
    layout = _config(tsa, "fixed").make_layout(256)
    a = tsk.device_lists(layout, True, 256, "cpu")
    assert tsk.device_lists(layout[:1], True, 256, "cpu") is a  # one shared head: the same entry
    assert tsk.device_lists(layout, False, 256, "cpu") is not a
    assert a.k_lists.dtype == torch.int32 and a.block == 16
    np.testing.assert_array_equal(a.q_counts.numpy(), tsk.layout_to_lists(layout[0], True)[3])


def _qkv(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal((B, S, H, D))).astype(np.float32) for _ in range(4))


ATTN_CASES = [(block, causal, mode) for block, mode in ((32, "bigbird"), (64, "fixed"), (128, "variable"))
              for causal in (True, False)]


@pytest.mark.parametrize("block,causal,mode", ATTN_CASES)
def test_forward_and_gradients_match_jax(block, causal, mode):
    S, H, D = 4 * block, 2, 16
    layout = _config(jsa, mode, seed=2, H=H, block=block).make_layout(S)
    q, k, v, g = _qkv(1, S, H, D, seed=block)

    def jloss(q, k, v):
        return jnp.sum(jsk.sparse_flash_attention(q, k, v, layout, causal=causal) * g)

    jout = jsk.sparse_flash_attention(*map(jnp.asarray, (q, k, v)), layout, causal=causal)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tsk.sparse_flash_attention(tq, tk, tv, layout, causal=causal, block=block)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    out.backward(torch.from_numpy(g))
    for port, ref, n in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL, err_msg=f"d{n}")


def test_key_block_no_query_attends_gets_zero_gradients():
    layout = np.zeros((4, 4), np.int64)
    layout[np.arange(4), np.arange(4)] = 1
    layout[:, 0] = 1
    layout[2, 2] = 0
    q, k, v, g = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 128, 2, 8, seed=5))
    tsk.sparse_flash_attention(q, k, v, layout).backward(g)
    assert k.grad[:, 64:96].abs().max().item() == 0.0 and v.grad[:, 64:96].abs().max().item() == 0.0
    assert k.grad[:, 96:].abs().max().item() > 0.0


def _lists_with_an_empty_row(layout, causal, empty, S):
    """The lists of ``layout`` with query block ``empty``'s list emptied
    (its count 0), as no layout gives them: ``layout_to_lists`` refuses a
    query block with no keys."""
    k_lists, k_counts, q_lists, q_counts = tsk.layout_to_lists(layout, causal)
    k_counts = k_counts.copy()
    k_counts[empty] = 0
    orders = tsk.grid_orders(k_counts, q_counts)
    tensors = [torch.from_numpy(a) for a in (k_lists, k_counts, q_lists, q_counts, *orders)]
    return tsk.SparseLists(*tensors[:4], block=S // layout.shape[0], dq_order=tensors[4], dkdv_order=tensors[5])


@pytest.mark.parametrize("causal", [True, False])
def test_query_block_with_an_empty_list_gets_zeros_like_pallas(causal):
    """A query block whose list is empty: the Pallas forward walks nothing
    and writes O = 0 and lse = m + log(l_safe) = NEG_INF; the plain forward
    gives the same, its padding entries adding nothing, and every other row
    as before. fp32, summation order only."""
    blk, n, B, H, D = 32, 4, 1, 2, 16
    S = n * blk
    layout = np.ones((n, n), np.int64)
    lists = _lists_with_an_empty_row(layout, causal, 2, S)
    assert int(lists.k_counts[2]) == 0 and int(lists.dq_order[-1]) == 2
    q, k, v, _ = _qkv(B, S, H, D, seed=12)
    scale = 1.0 / np.sqrt(D)

    def bh(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))

    jout, jlse = jsk._sparse_forward(bh(q), bh(k), bh(v), jnp.asarray(lists.k_lists.numpy()),
                                     jnp.asarray(lists.k_counts.numpy()), scale, causal, blk, True)
    out, lse = tsk.sparse_attention_reference(*map(torch.from_numpy, (q, k, v)), lists, causal=causal)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3).reshape(B * H, S, D), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy().reshape(B * H, S), np.asarray(jlse), rtol=RTOL, atol=ATOL)
    rows = slice(2 * blk, 3 * blk)
    assert out[:, rows].abs().max().item() == 0.0 and (lse[:, :, rows] == tsk.NEG_INF).all()
    dout = torch.ones_like(out)
    dq, _, _ = tsk.sparse_attention_backward_reference(*map(torch.from_numpy, (q, k, v)), out, lse, dout, lists,
                                                       causal=causal)
    assert dq[:, rows].abs().max().item() == 0.0


def test_argument_rules_match_jax():
    q = torch.zeros(1, 128, 2, 8)
    jq = jnp.zeros((1, 128, 2, 8))
    per_head = np.stack([np.eye(4, dtype=np.int64), np.tril(np.ones((4, 4), np.int64))])
    for fn, x in ((tsk.sparse_flash_attention, q), (jsk.sparse_flash_attention, jq)):
        with pytest.raises(NotImplementedError):
            fn(x, x, x, per_head)
        with pytest.raises(ValueError):  # 128 rows over 3 blocks
            fn(x, x, x, np.ones((3, 3)))
        with pytest.raises(ValueError):  # block 32 disagrees with the layout's
            fn(x, x, x, np.ones((4, 4)), block=16)
    same = np.stack([np.tril(np.ones((4, 4), np.int64))] * 2)  # identical heads are accepted
    assert tsk.sparse_flash_attention(q, q, q, same).shape == q.shape


def test_cpu_tensors_count_no_launch_and_kernel_entry_points_need_cuda():
    q, k, v, _ = map(torch.from_numpy, _qkv(1, 128, 2, 8, seed=6))
    counters = (tsk.sparse_forward, tsk.sparse_backward_dq, tsk.sparse_backward_dkdv)
    before = [c.launches for c in counters]
    q.requires_grad_(True)
    tsk.sparse_flash_attention(q, k, v, np.ones((4, 4))).sum().backward()
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        tsk.sparse_forward(q.detach(), k, v, tsk.device_lists(np.ones((4, 4)), True, 128, "cpu"))


def test_backward_reference_matches_autograd_of_dense_masked_attention():
    """The plain versions against autograd through the dense softmax with
    the layout as a mask (fp32; summation order only)."""
    layout = _config(tsa, "bigbird", seed=4, H=2).make_layout(128)
    q, k, v, g = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(2, 128, 2, 8, seed=7))
    mask = torch.from_numpy(np.kron(layout[0].astype(bool), np.ones((16, 16), bool))) & torch.ones(
        128, 128, dtype=torch.bool).tril()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(torch.where(mask, s, -1e30), -1), v)
    grads = torch.autograd.grad(dense, (q, k, v), g)
    lists = tsk.device_lists(layout, True, 128, "cpu")
    with torch.no_grad():
        out, lse = tsk.sparse_attention_reference(q, k, v, lists)
        torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
        mine = tsk.sparse_attention_backward_reference(q, k, v, out, lse, g, lists)
    for a, b in zip(mine, grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The Hopper backward's host side: its parameter block, grid orders and route
# ---------------------------------------------------------------------------

_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const float*": ctypes.c_void_p, "const int*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _sparse_params_fields():
    """(name, ctypes type) of ``SparseParams`` in ``csrc/sparse_attention.cu``, field by field."""
    src = (Path(tsk.__file__).resolve().parents[2] / "csrc" / "sparse_attention.cu").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct SparseParams \{(.*?)\n\};", src, re.S).group(1))
    fields = []
    for decl in (d.strip() for d in body.split(";")):
        if not decl:
            continue
        m = re.match(r"((?:const )?(?:void|float|int|long long)\*?)\s+(.*)", decl)
        ctype, names = m.group(1), m.group(2)
        for name in (n.strip() for n in names.split(",")):
            arr = re.match(r"(\w+)\[(\d+)\]", name)
            if arr:
                assert ctype == "long long"
                fields.append((arr.group(1), ctypes.c_longlong * int(arr.group(2))))
            else:
                fields.append((name, _CTYPES[ctype]))
    return fields


def test_params_struct_mirrors_the_kernels_sparse_params():
    """The ctypes block the wrapper fills is ``SparseParams`` as the kernel
    source declares it: same fields, same order, same types."""
    theirs = _sparse_params_fields()
    assert [name for name, _ in tsk._Params._fields_] == [name for name, _ in theirs]
    for (name, ours), (_, want) in zip(tsk._Params._fields_, theirs):
        assert ctypes.sizeof(ours) == ctypes.sizeof(want), name
        assert getattr(ours, "_type_", ours) == getattr(want, "_type_", want), name
    assert len(theirs) == 16 + 8 + 9 + 1


def _unattended_layout(n=8):
    """Diagonal plus a global first column; key block 5 attended by none."""
    layout = np.eye(n, dtype=np.int64)
    layout[:, 0] = 1
    layout[5, 5] = 0
    return layout


TABLE_LAYOUTS = {
    "fixed-64": lambda: tsa.SPARSITY_CONFIGS["fixed"](num_heads=12, block=64, num_local_blocks=4, num_global_blocks=1,
                                                      attention="unidirectional").make_layout(8192)[0],
    "bigbird-128": lambda: tsa.SPARSITY_CONFIGS["bigbird"](num_heads=12, block=128, num_random_blocks=2,
                                                           num_sliding_window_blocks=3,
                                                           num_global_blocks=1).make_layout(8192)[0],
    "unattended": _unattended_layout,
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(TABLE_LAYOUTS))
def test_grid_orders_are_permutations_longest_first(name, causal):
    """dq_order and dkdv_order are permutations of the query and the key
    blocks, longest list first, ties in block order; a key block no query
    attends comes last."""
    _, k_counts, _, q_counts = tsk.layout_to_lists(TABLE_LAYOUTS[name](), causal=causal)
    for order, counts in zip(tsk.grid_orders(k_counts, q_counts), (k_counts, q_counts)):
        assert order.dtype == np.int32
        assert sorted(order.tolist()) == list(range(len(counts)))
        assert order.tolist() == sorted(range(len(counts)), key=lambda i: (-counts[i], i))
    if name == "unattended":
        assert tsk.grid_orders(k_counts, q_counts)[1][-1] == 5 and q_counts[5] == 0


def test_device_lists_carry_the_backward_tables():
    """The lists carry the grid orders as contiguous int32 tensors. At the
    long-sequence slice's fixed-64 layout the first dK/dV CTA walks the
    longest transposed list, 125 query blocks."""
    layout = TABLE_LAYOUTS["fixed-64"]()
    lists = tsk.device_lists(layout, True, 8192, "cpu")
    want = tsk.grid_orders(lists.k_counts.numpy(), lists.q_counts.numpy())
    for got, ref in zip((lists.dq_order, lists.dkdv_order), want):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(lists.q_counts[lists.dkdv_order[0]]) == int(lists.q_counts.max()) == 125
    assert int(lists.k_counts[lists.dq_order[0]]) == int(lists.k_counts.max())


@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_dkdv_walk_equals_the_plain_backward(causal, parity):
    """A plain emulation of the Hopper dK/dV's walk: one key block a CTA in
    ``dkdv_order``, over its whole list; with ``parity`` (block 64) two
    accumulators take alternate entries and the second is added to the
    first at the end. It equals ``sparse_attention_backward_reference``
    within fp32 rounding, and a key block no query attends writes zeros."""
    blk, n, B, H, D = 16, 12, 2, 2, 8
    layout = _unattended_layout(n)
    layout[:, 1] = 1
    S = n * blk
    q, k, v, dout = map(torch.from_numpy, _qkv(B, S, H, D, seed=11))
    lists = tsk.device_lists(layout, causal, S, "cpu")
    scale = 1.0 / np.sqrt(D)
    out, lse = tsk.sparse_attention_reference(q, k, v, lists, causal=causal)
    _, dk_ref, dv_ref = tsk.sparse_attention_backward_reference(q, k, v, out, lse, dout, lists, causal=causal)
    delta = (dout * out).sum(-1).permute(0, 2, 1)  # [B, H, S]

    def rows(t, i):
        return t[:, i * blk:(i + 1) * blk]

    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    for kj in lists.dkdv_order.tolist():
        acc = [(torch.zeros(B, blk, H, D), torch.zeros(B, blk, H, D)) for _ in range(1 + parity)]
        for j, qi in enumerate(lists.q_lists[kj, :lists.q_counts[kj]].tolist()):
            acc_k, acc_v = acc[j % 2 if parity else 0]
            s = torch.einsum("bihd,bjhd->bhij", rows(q, qi), rows(k, kj)) * scale
            if causal and qi == kj:
                s = torch.where(torch.ones(blk, blk, dtype=torch.bool).tril(), s, tsk.NEG_INF)
            p = torch.exp(s - lse[:, :, qi * blk:(qi + 1) * blk, None])
            ds = p * (torch.einsum("bihd,bjhd->bhij", rows(dout, qi), rows(v, kj))
                      - delta[:, :, qi * blk:(qi + 1) * blk, None])
            acc_v += torch.einsum("bhij,bihd->bjhd", p, rows(dout, qi))
            acc_k += torch.einsum("bhij,bihd->bjhd", ds, rows(q, qi))
        acc_k, acc_v = acc[0]
        if parity:
            acc_k, acc_v = acc_k + acc[1][0], acc_v + acc[1][1]
        rows(dk, kj)[:], rows(dv, kj)[:] = acc_k * scale, acc_v
    assert rows(dk, 5).abs().max().item() == 0.0 and rows(dv, 5).abs().max().item() == 0.0
    torch.testing.assert_close(dk, dk_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-5, atol=1e-5)


def _route_inputs(dtype, D, view):
    shape = (1, 18 * 128, 2, D)
    if view:  # base 4 bytes past 16-byte alignment, strides of 68 elements
        return tuple(torch.zeros(*shape[:3], 68, dtype=dtype)[..., 2:2 + D] for _ in range(4))
    return tuple(torch.zeros(shape, dtype=dtype) for _ in range(4))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("inputs", ["D64", "D100", "unaligned_view"])
@pytest.mark.parametrize("block", tsk.BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_backward_route_is_chosen_before_the_launch(monkeypatch, dtype, block, inputs, causal):
    """16-bit inputs at blocks 64 and 128 take the Hopper route, the forward
    as the backward: what TMA cannot read (D = 100, a view off 16 bytes)
    reaches the kernels as padded copies, and the output and the gradients
    come back at the caller's head dim. Everything else reaches the tiled
    kernels as it is. Each wrapper launches its one kernel once. The launch
    is stubbed: what is checked is what would reach it."""
    given, launched = [], []

    def params(q, k, v, lists, causal, scale, **tensors):
        given.append(dict(q=q, k=k, v=v, causal=causal, **tensors))
        return tsk._Params()

    monkeypatch.setattr(tsk, "_params", params)
    monkeypatch.setattr(tsk, "_launch", lambda name, p, device: launched.append(name))
    counters = (tsk.sparse_forward, tsk.sparse_backward_dq, tsk.sparse_backward_dkdv)
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
    D = 100 if inputs == "D100" else 64
    q, k, v, dout = _route_inputs(dtype, D, inputs == "unaligned_view")
    S = q.shape[1]
    layout = np.eye(S // block, dtype=np.int64)
    layout[:, 0] = 1
    lists = tsk.device_lists(layout, causal, S, "cpu")
    lse, delta = torch.zeros(1, 2, S), torch.zeros(1, 2, S)
    hopper = tsk.hopper_route(dtype, block)
    assert hopper == (dtype != torch.float32 and block in (64, 128))
    padded = hopper and inputs != "D64"

    out, lse_out = tsk.sparse_forward(q, k, v, lists, causal=causal)
    dq = tsk.sparse_backward_dq(q, k, v, dout, lse, delta, lists, causal=causal)
    dk, dv = tsk.sparse_backward_dkdv(q, k, v, dout, lse, delta, lists, causal=causal)
    assert launched == ["dstt_sparse_fwd", "dstt_sparse_bwd_dq", "dstt_sparse_bwd_dkdv"]
    assert [c.launches for c in counters] == [1, 1, 1]
    assert "dout" not in given[0] and given[0]["out"].shape[:3] == q.shape[:3]
    for call in given:
        assert call["causal"] is causal
        read = [call[n] for n in ("q", "k", "v", "dout") if n in call]
        if padded:
            assert all(t.shape[-1] == -(-D // 8) * 8 for t in read)
            assert not any(tsk.needs_padding(t) for t in read)
        else:
            assert all(a is b for a, b in zip(read, (q, k, v, dout)))
    assert all(t.shape == q.shape and t.dtype == dtype for t in (out, dq, dk, dv))
    assert lse_out.shape == (1, 2, S) and lse_out.dtype == torch.float32


def test_sparse_self_attention_matches_jax_with_and_without_masks():
    B, S, H, D = 2, 128, 2, 16
    q, k, v, _ = _qkv(B, S, H, D, seed=8)
    kp = np.ones((B, S), np.float32)
    kp[:, S // 2 + 5:] = 0
    am3 = (np.random.default_rng(9).standard_normal((B, S, S)) * 0.5).astype(np.float32)
    for causal, scale in ((True, None), (False, 0.3)):
        jmod = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(num_heads=H, block=32, num_local_blocks=2),
                                       causal=causal, softmax_scale=scale)
        tmod = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=H, block=32, num_local_blocks=2),
                                       causal=causal, softmax_scale=scale)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        for kw in ({}, {"key_padding_mask": kp}, {"attn_mask": kp}, {"attn_mask": am3, "key_padding_mask": kp}):
            np.testing.assert_allclose(tmod(tq, tk, tv, **kw).numpy(), np.asarray(jmod(jq, jk, jv, **kw)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"causal={causal} {sorted(kw)}")


def test_bert_sparse_self_attention_with_jax_weights():
    jmod = jsa.BertSparseSelfAttention(32, 2, jsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2))
    tmod = tsa.BertSparseSelfAttention(32, 2, tsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(10).standard_normal((2, 64, 32)).astype(np.float32)
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    for m in (None, mask):
        ref = jmod.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), m)
        got = tmod.apply(tparams, torch.from_numpy(x), m)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    own = tmod.init(torch.Generator().manual_seed(0))
    assert {k: tuple(t.shape) for k, t in own.items()} == {k: v.shape for k, v in params.items()}


def test_sparse_attention_utils_match_jax():
    toks = np.arange(100, dtype=np.int32).reshape(2, 50)
    emb = np.random.default_rng(11).standard_normal((2, 50, 8)).astype(np.float32)
    mask = np.ones((2, 50), np.int32)
    jout = jsa.SparseAttentionUtils.pad_to_block_size(32, jnp.asarray(toks), jnp.asarray(emb),
                                                      jnp.asarray(mask), pad_token_id=7)
    tout = tsa.SparseAttentionUtils.pad_to_block_size(32, torch.from_numpy(toks), torch.from_numpy(emb),
                                                      torch.from_numpy(mask), pad_token_id=7)
    assert tout[0] == jout[0] == 14
    for got, ref in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tsa.SparseAttentionUtils.pad_to_block_size(25, torch.from_numpy(toks))[0] == 0
    seq = np.ones((2, 64, 8), np.float32)
    assert tuple(tsa.SparseAttentionUtils.unpad_sequence_output(14, torch.from_numpy(seq)).shape) == (2, 50, 8)
    pos = np.arange(48, dtype=np.float32).reshape(12, 4)
    np.testing.assert_array_equal(
        tsa.SparseAttentionUtils.extend_position_embedding(torch.from_numpy(pos), 30).numpy(),
        np.asarray(jsa.SparseAttentionUtils.extend_position_embedding(jnp.asarray(pos), 30)))


SPARSITY = {"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 3}


@pytest.mark.parametrize("kw", [{"sparsity": SPARSITY, "loss_chunk_size": 16},
                                {"sparsity": {"mode": "fixed", "block": 16, "num_local_blocks": 2},
                                 "pos_emb": "rotary"}], ids=["bslongformer", "fixed_rotary"])
def test_model_loss_and_gradients_match_jax(kw):
    """causal_lm_loss and its gradients with attn_impl='sparse' from the
    same weights (interop.params_from_jax); 1e-5 on the loss, gradients as
    tests/test_torch_training.py."""
    jcfg, tcfg, jparams = _models(attn_impl="sparse", **kw)
    toks = np.random.default_rng(1).integers(0, 97, size=(2, 65)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jtfm.causal_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}))(
        jax.tree.map(jnp.asarray, jparams))
    tp = topt.tree_map(lambda t: t.requires_grad_(True), interop.params_from_jax(jparams))
    tl = ttfm.causal_lm_loss(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for port, ref in zip(_leaves(topt.tree_map(lambda t: t.grad, tp)), jax.tree.leaves(jg)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5)


def test_alibi_bias_takes_plain_attention_in_the_sparse_dispatch(monkeypatch):
    """A dense bias (ALiBi here) goes to plain attention, as in JAX."""
    cfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=1, num_heads=4, hidden_size=32,
                                 attn_impl="sparse", sparsity=SPARSITY, pos_emb="alibi")
    calls = []
    monkeypatch.setattr(ttfm, "sparse_flash_attention", lambda *a, **k: calls.append(1))
    params = ttfm.init(cfg, torch.Generator().manual_seed(0))
    ref = ttfm.apply(cfg.replace(attn_impl="xla"), params, torch.zeros(1, 64, dtype=torch.long))
    torch.testing.assert_close(ttfm.apply(cfg, params, torch.zeros(1, 64, dtype=torch.long)), ref)
    assert calls == []


@pytest.mark.parametrize("policy", ["nothing_saveable", "everything_saveable", "dots_saveable", "save_flash",
                                    "dots_and_flash"])
def test_remat_with_sparse_gives_the_no_remat_gradients(monkeypatch, policy):
    """Every remat policy gives the no-remat loss and gradients exactly, and
    recomputes the sparse forward (it carries no checkpoint name, as in
    JAX): 2 forwards per layer, except everything_saveable's 1."""
    cfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32,
                                 attn_impl="sparse", sparsity=SPARSITY, loss_chunk_size=16)
    params = ttfm.init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 97, size=(2, 65)))

    def loss_and_grads(c):
        leaves = topt.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        loss = ttfm.causal_lm_loss(c, leaves, {"tokens": tokens})
        loss.backward()
        return loss.item(), topt.tree_leaves(topt.tree_map(lambda t: t.grad, leaves))

    ref_loss, ref_grads = loss_and_grads(cfg)
    calls = []
    plain = tsk.sparse_attention_reference
    monkeypatch.setattr(tsk, "sparse_attention_reference", lambda *a, **k: calls.append(1) or plain(*a, **k))
    loss, grads = loss_and_grads(cfg.replace(remat=True, remat_policy=policy))
    assert loss == ref_loss
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert len(calls) == (2 if policy == "everything_saveable" else 4)


def test_apply_with_cache_refuses_sparse():
    tcfg = ttfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=1, num_heads=4, hidden_size=32,
                                  attn_impl="sparse", sparsity=SPARSITY)
    jcfg = jtfm.TransformerConfig(vocab_size=97, max_seq_len=64, num_layers=1, num_heads=4, hidden_size=32,
                                  attn_impl="sparse", sparsity=SPARSITY)
    tparams = ttfm.init(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="block-sparse decode") as terr:
        ttfm.apply_with_cache(tcfg, tparams, torch.zeros(1, 4, dtype=torch.long), ttfm.init_cache(tcfg, 1, 64), 0)
    with pytest.raises(NotImplementedError) as jerr:
        jtfm.apply_with_cache(jcfg, jtfm.init(jcfg, jax.random.PRNGKey(0)), jnp.zeros((1, 4), jnp.int32),
                              jtfm.init_cache(jcfg, 1, 64), 0)
    assert str(terr.value) == str(jerr.value)


SPARSE_DS = base_config(
    train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2,
    optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    sparse_attention={"mode": "fixed", "block": 16, "num_local_blocks": 2, "num_global_blocks": 1,
                      "attention": "unidirectional", "num_random_blocks": 3},
)


def test_sparse_attention_and_curriculum_blocks_parse_like_jax():
    from deepspeed_tpu.runtime import config as jconfig

    d = dict(SPARSE_DS, curriculum_learning={"enabled": True, "min_difficulty": 16, "max_difficulty": 64,
                                             "schedule_type": "fixed_linear",
                                             "schedule_config": {"total_curriculum_step": 8}},
             dataloader_drop_last=True)
    j, t = jconfig.DeepSpeedConfig.from_dict(d), tconfig.DeepSpeedConfig.from_dict(d)
    assert vars(t.sparse_attention) == vars(j.sparse_attention)
    assert vars(t.curriculum_learning) == vars(j.curriculum_learning)
    assert t.dataloader_drop_last is j.dataloader_drop_last is True
    assert tconfig.DeepSpeedConfig.from_dict({"train_batch_size": 2}).sparse_attention is None


def test_train_batch_with_the_sparse_attention_block_tracks_jax():
    """initialize -> 3 × train_batch, both engines turning the DeepSpeed
    ``sparse_attention`` block into the same model fields, fp32, from the
    same weights: loss 1e-5 and grad norm 1e-4 relative."""
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=SPARSE_DS, mesh=single_device_mesh())
    tcfg = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=ttfm.Model(tcfg), config=SPARSE_DS,
        model_parameters=interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"])), device="cpu")
    mc = teng.model.config
    assert mc.attn_impl == jeng.model.config.attn_impl == "sparse"
    assert mc.sparsity == jeng.model.config.sparsity and "num_random_blocks" not in mc.sparsity
    tokens = np.random.default_rng(0).integers(0, 128, size=(4, 65)).astype(np.int32)
    for _ in range(3):
        jm = jax.device_get(jeng.train_batch({"tokens": tokens}))
        tm = teng.train_batch({"tokens": tokens})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def _custom(step):
    return 8 * (step + 1)


SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 100, "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 37, "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 16, "max_difficulty": 256, "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 50, "difficulty_step": 16, "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 2048, "max_difficulty": 8192, "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [2048, 4096, 8192], "max_step": [1, 2]}},
    "custom": {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "custom",
               "schedule_config": {"custom_fn": _custom}},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_curriculum_scheduler_matches_jax(name):
    d = {"enabled": True, **SCHEDULES[name]}
    js, ts = jcs.CurriculumScheduler(d), tcs.CurriculumScheduler(d)
    for step in list(range(60)) + [100, 10_000]:
        assert ts.update_difficulty(step) == js.update_difficulty(step), step
    assert ts.state_dict() == js.state_dict()
    fresh = tcs.CurriculumScheduler(d)
    fresh.load_state_dict(js.state_dict())
    assert fresh.get_current_difficulty() == js.get_current_difficulty()


def test_curriculum_truncates_each_batch_like_jax():
    """The engines' hook: every leaf of rank >= 2 cut to difficulty + 1."""
    ds = dict(base_config(train_batch_size=2, gradient_accumulation_steps=1, train_micro_batch_size_per_gpu=2),
              curriculum_learning={"enabled": True, **SCHEDULES["fixed_linear"]})
    jeng, _, _, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(TCFG), config=ds, device="cpu")
    batch = {"tokens": np.zeros((2, 129), np.int32), "labels": np.zeros((2, 129), np.int32),
             "weights": np.ones(2, np.float32)}
    for step in (0, 5, 20, 40):
        jeng.global_steps = teng.global_steps = step
        ref = jeng._apply_curriculum(batch)
        got = teng._apply_curriculum(batch)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}, step


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_dataloader_order_and_state_match_jax(shuffle, drop_last):
    data = [{"tokens": np.full(3, i, np.int32)} for i in range(23)]
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_last=drop_last)
    jl, tl = jdl.DeepSpeedDataLoader(data, **kw), tdl.DeepSpeedDataLoader(data, **kw)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        jl.set_epoch(epoch), tl.set_epoch(epoch)
        for jb, tb in zip(jl, tl, strict=True):
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    jit, tit = iter(jl), iter(tl)
    for _ in range(3):
        next(jit), next(tit)
    assert tl.state_dict() == jl.state_dict()
    resumed = tdl.DeepSpeedDataLoader(data, **kw)
    resumed.load_state_dict(jl.state_dict())
    for jb, tb in zip(jit, resumed, strict=True):
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    looped = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data[:5], batch_size=2))
    assert [int(next(looped)["tokens"][0, 0]) for _ in range(4)] == [0, 2, 4, 0]
    pairs = tdl._default_collate([(np.zeros(2), 1), (np.ones(2), 2)])
    assert pairs[0].shape == (2, 2) and list(pairs[1]) == [1, 2]


def _curriculum_ds():
    return dict(base_config(train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2,
                            optimizer={"type": "AdamW", "params": {"lr": 1e-3}}),
                curriculum_learning={"enabled": True, "min_difficulty": 16, "max_difficulty": 64,
                                     "schedule_type": "fixed_discrete",
                                     "schedule_config": {"difficulty": [16, 32, 64], "max_step": [1, 2]}})


DATA = [{"tokens": row} for row in np.random.default_rng(3).integers(0, 128, size=(24, 65)).astype(np.int32)]
TCFG = ttfm.TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)


def test_initialize_returns_a_loader_that_trains_like_jax():
    """initialize(training_data=...) returns the engine's loader in the
    third slot; three steps from it follow the curriculum's lengths and
    track the JAX engine fed by its own loader."""
    ds = _curriculum_ds()
    jeng, _, jloader, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh(),
                                                   training_data=DATA)
    teng, _, tloader, _ = deepspeed_tpu_torch.initialize(
        model=ttfm.Model(TCFG), config=ds, training_data=DATA, device="cpu",
        model_parameters=interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"])))
    assert isinstance(tloader, tdl.DeepSpeedDataLoader) and teng.training_dataloader is tloader
    assert len(tloader) == len(jloader) == 6
    lengths = []
    for _, jb, tb in zip(range(3), jloader, tloader):
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
        jm, tm = jax.device_get(jeng.train_batch(jb)), teng.train_batch(tb)
        lengths.append(teng.curriculum_scheduler.get_current_difficulty())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert lengths == [16, 16, 32]
    assert teng._dl_cursor == jeng._dl_cursor


def test_checkpoint_carries_curriculum_and_loader_state_both_ways(tmp_path):
    """A checkpoint saved by either package restores the other's curriculum
    difficulty and loader cursor (format 3 client state)."""
    ds = _curriculum_ds()
    teng, _, tloader, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(TCFG), config=ds, training_data=DATA,
                                                         device="cpu")
    for _, b in zip(range(3), tloader):
        teng.train_batch(b)
    teng.save_checkpoint(str(tmp_path / "port"))
    jeng, _, jloader, _ = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh(),
                                                   training_data=DATA)
    _, client = jeng.load_checkpoint(str(tmp_path / "port"))
    assert client["curriculum"] == teng.curriculum_scheduler.state_dict() == {"current_difficulty": 32,
                                                                              "first_step": True}
    assert jeng.curriculum_scheduler.state_dict() == teng.curriculum_scheduler.state_dict()
    assert jloader.state_dict() == teng._dl_cursor and jloader.state_dict()["batches_yielded"] == 3
    batch = next(iter(jloader))  # the loader resumes at the fourth batch
    np.testing.assert_array_equal(batch["tokens"], np.stack([d["tokens"] for d in DATA[12:16]]))

    jeng.train_batch(batch)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    fresh, _, floader, _ = deepspeed_tpu_torch.initialize(model=ttfm.Model(TCFG), config=ds, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "jax"))  # before any loader exists: the cursor waits
    assert fresh.curriculum_scheduler.state_dict() == jeng.curriculum_scheduler.state_dict()
    loader = fresh.deepspeed_io(DATA)
    assert loader.state_dict() == jeng._dl_cursor
    np.testing.assert_array_equal(next(iter(loader))["tokens"], np.stack([d["tokens"] for d in DATA[16:20]]))


def test_port_resume_through_the_loader_is_bitwise(tmp_path):
    """train 2 from the loader + save + fresh engine and loader + load +
    train 2 == train 4 straight, losses and lengths bitwise."""
    ds = _curriculum_ds()

    def engine():
        return deepspeed_tpu_torch.initialize(model=ttfm.Model(TCFG), config=ds, training_data=DATA, device="cpu",
                                              model_parameters=ttfm.init(TCFG, torch.Generator().manual_seed(1)))

    straight, _, loader, _ = engine()
    ref = [float(straight.train_batch(b)["loss"]) for _, b in zip(range(4), loader)]
    first, _, loader, _ = engine()
    got = [float(first.train_batch(b)["loss"]) for _, b in zip(range(2), loader)]
    first.save_checkpoint(str(tmp_path))
    second, _, loader, _ = engine()
    second.load_checkpoint(str(tmp_path))
    got += [float(second.train_batch(b)["loss"]) for _, b in zip(range(2), loader)]
    assert got == ref
    assert second.curriculum_scheduler.get_current_difficulty() == 64
