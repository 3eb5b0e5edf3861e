"""Port parity: flash attention, forward and gradients.

The same numpy inputs go through the JAX ``flash_attention`` (the Pallas
kernels in interpret mode, as ``tests/test_flash_attention.py`` runs them on
the CPU) and the port's ``flash_attention`` on CPU tensors, which takes the
plain versions the CUDA kernels are held against on the card.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jflash
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides; the forward differs by summation order only (the JAX
# package's own flash-vs-xla tolerance, tests/test_flash_attention.py:33)
FWD_TOL = 2e-5
# gradients: the backward's dS = P∘(dP − Δ) cancels, so relative error grows;
# the JAX package's own flash-vs-xla gradient tolerance (:64)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _qkv(B=2, S=256, H=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((0.5 * rng.standard_normal((B, S, H, D))).astype(np.float32) for _ in range(3))


def _jax_kw(kw):
    out = dict(kw)
    if "alibi_slopes" in out:
        out["alibi_slopes"] = jnp.asarray(out["alibi_slopes"])
    return out


def _torch_kw(kw):
    out = dict(kw)
    if "alibi_slopes" in out:
        out["alibi_slopes"] = torch.from_numpy(np.asarray(out["alibi_slopes"]))
    return out


CASES = {
    "causal": (256, {"causal": True}),
    "bidirectional": (256, {"causal": False}),
    "alibi": (256, {"causal": True, "alibi_slopes": np.asarray(ttfm.alibi_slopes(4))}),
    "window": (256, {"causal": True, "window": 48.0}),
    "window_off": (128, {"causal": True, "window": 0.0}),
    "unaligned_causal": (200, {"causal": True}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    S, kw = CASES[name]
    q, k, v = _qkv(S=S)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
                 **_jax_kw(kw))
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), block_q=128, block_k=128,
                              **_torch_kw(kw))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["causal", "bidirectional", "alibi", "window", "unaligned_causal"])
def test_gradients_match_jax(name):
    S, kw = CASES[name]
    q, k, v = _qkv(B=1, S=S, H=4, D=16, seed=1)

    def jloss(q, k, v):
        return jnp.sum(jnp.square(jflash(q, k, v, **_jax_kw(kw))))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    torch.sum(torch.square(tfa.flash_attention(tq, tk, tv, **_torch_kw(kw)))).backward()
    for port, ref, n in zip((tq.grad, tk.grad, tv.grad), jg, "qkv"):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 40.0},
                                {"causal": True, "alibi": True}])
def test_backward_reference_matches_autograd_of_plain_attention(kw):
    """``flash_attention_backward_reference`` against autograd through the
    plain masked softmax (fp32; summation order only, hence 1e-5)."""
    kw = dict(kw)
    slopes = ttfm.alibi_slopes(3) if kw.pop("alibi", False) else None
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(B=2, S=96, H=3, D=16, seed=2))
    dout = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 96, 3, 16)).astype(np.float32))
    scale = 1.0 / 4.0
    s = tfa._scores(q, k, kw["causal"], scale, slopes, kw.get("window"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        out_ref, lse = tfa.flash_attention_reference(q, k, v, sm_scale=scale, alibi_slopes=slopes, **kw)
        torch.testing.assert_close(out_ref, out, rtol=1e-5, atol=1e-5)
        mine = tfa.flash_attention_backward_reference(q, k, v, out_ref, lse, dout, sm_scale=scale,
                                                      alibi_slopes=slopes, **kw)
    for a, b in zip(mine, grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_argument_rules_match_jax():
    q, k, v = (torch.zeros(1, 200, 2, 16) for _ in range(3))
    jq = jnp.zeros((1, 200, 2, 16))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1, 2, 200, 200))
    for fn, args in ((tfa.flash_attention, (q, k, v)), (jflash, (jq, jq, jq))):
        with pytest.raises(ValueError):  # non-causal needs 128-aligned lengths
            fn(*args, causal=False)
    kq = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError):  # causal cross-attention, unaligned
        tfa.flash_attention(q, kq, kq)
    with pytest.raises(ValueError):
        jflash(jq, jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)))
    q256 = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError):  # 256 is not a multiple of block_q 96
        tfa.flash_attention(q256, q256, q256, block_q=96)
    with pytest.raises(ValueError):
        jflash(jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)), jnp.zeros((1, 256, 2, 16)),
               block_q=96)


def test_cpu_tensors_count_no_launch_and_kernel_entry_points_need_cuda():
    q, k, v = map(torch.from_numpy, _qkv(B=1, S=128, H=2, D=16))
    counters = (tfa.flash_forward, tfa.flash_backward_dkdv, tfa.flash_backward_dq)
    before = [f.launches for f in counters]
    q.requires_grad_(True)
    tfa.flash_attention(q, k, v).sum().backward()
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_forward(q.detach(), k, v)


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "const float*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _flash_params_fields():
    """(name, ctypes type) of ``FlashParams`` in ``csrc/flash_attention.cu``, field by field."""
    src = (Path(tfa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct FlashParams \{(.*?)\n\};", src, re.S).group(1))
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


def test_params_struct_mirrors_the_kernels_flash_params():
    """The ctypes block the wrapper fills is ``FlashParams`` as the kernel
    source declares it: same fields, same order, same types."""
    theirs = _flash_params_fields()
    assert [name for name, _ in tfa._Params._fields_] == [name for name, _ in theirs]
    for (name, ours), (_, want) in zip(tfa._Params._fields_, theirs):
        assert ctypes.sizeof(ours) == ctypes.sizeof(want), name
        assert getattr(ours, "_type_", ours) == getattr(want, "_type_", want), name
    assert len(theirs) == 12 + 8 + 7 + 1


@pytest.mark.parametrize("D", [8, 100])
def test_padding_route_gives_the_unpadded_results_exactly(D):
    """pad → plain forward and backward → slice equals the plain results on
    the unpadded inputs. Integer-valued q/k/v make every score and dO·V
    exact whatever the summation order, and dO is non-zero in one head-dim
    column so that Δ = rowsum(dO∘O) is one product: the comparison is
    bitwise."""
    rng = np.random.default_rng(5)
    B, S, H = 2, 72, 3
    q, k, v = (torch.from_numpy(rng.integers(-2, 3, (B, S, H, D)).astype(np.float32)) for _ in range(3))
    dout = torch.zeros(B, S, H, D)
    dout[..., D // 2] = torch.from_numpy(rng.standard_normal((B, S, H)).astype(np.float32))
    scale = 0.125 / np.sqrt(D)  # the real head dim's scale, kept through the padding
    kw = dict(causal=True, sm_scale=scale, alibi_slopes=ttfm.alibi_slopes(H))
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    grads = tfa.flash_attention_backward_reference(q, k, v, out, lse, dout, **kw)
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, dout)
    assert qp.shape[-1] % 8 == 0 and qp.shape[-1] - D < 8 and qp.is_contiguous()
    assert qp[..., D:].abs().max().item() == 0 if qp.shape[-1] > D else True
    out_p, lse_p = tfa.flash_attention_reference(qp, kp, vp, **kw)
    grads_p = tfa.flash_attention_backward_reference(qp, kp, vp, out_p, lse_p, dop, **kw)
    assert torch.equal(out_p[..., :D], out) and torch.equal(lse_p, lse)
    for got, want in zip(grads_p, grads):
        assert torch.equal(got[..., :D], want)


def test_padding_route_is_chosen_from_the_shape_and_strides():
    """16-bit inputs go to the padded copies when a head dim or a stride is
    not a multiple of 8 elements or a base is not 16-byte aligned; fp32
    inputs never do (their kernels read any of them)."""
    bf = torch.zeros(2, 64, 3, 64, dtype=torch.bfloat16)
    assert not tfa.needs_padding(bf, bf, bf)
    assert tfa.needs_padding(torch.zeros(2, 64, 3, 100, dtype=torch.bfloat16))
    wide = torch.zeros(2, 64, 3, 72, dtype=torch.bfloat16)
    assert tfa.needs_padding(wide[..., 1:65])  # base off 16 bytes, strides 216 = 27 x 8 elements
    assert tfa.needs_padding(torch.zeros(2, 64, 3, 68, dtype=torch.float16)[..., :64])  # strides not x 8
    assert not tfa.needs_padding(wide[..., 8:72])  # 16-byte base, strides multiples of 8
    assert not tfa.needs_padding(torch.zeros(2, 64, 3, 100))  # fp32
    padded, = tfa.pad_head_dim(torch.ones(2, 64, 3, 100, dtype=torch.bfloat16))
    assert padded.shape[-1] == 104 and not tfa.needs_padding(padded)


@pytest.mark.parametrize("entry", ["flash_forward", "flash_backward_dkdv", "flash_backward_dq"])
def test_each_entry_point_chooses_the_padding_route_before_the_launch(monkeypatch, entry):
    """Every entry point hands the kernel padded copies when ``needs_padding``
    says so (D = 100 here) and the caller's own tensors otherwise, and slices
    its outputs back to the caller's head dim. The launch is stubbed: what is
    checked is what would reach the kernel."""
    seen = []
    monkeypatch.setattr(tfa, "_params", lambda q, k, v, *args, **tensors: seen.append(dict(q=q, k=k, v=v, **tensors)))
    monkeypatch.setattr(tfa, "_launch", lambda name, p, device: None)
    monkeypatch.setattr(getattr(tfa, entry), "launches", 0)
    for D, padded in ((100, True), (64, False)):
        q, k, v, dout = (torch.zeros(2, 64, 3, D, dtype=torch.bfloat16) for _ in range(4))
        lse, delta = torch.zeros(2, 3, 64), torch.zeros(2, 3, 64)
        if entry == "flash_forward":
            outs = tfa.flash_forward(q, k, v)[:1]
        else:
            fn = getattr(tfa, entry)
            outs = fn(q, k, v, dout, lse, delta)
            outs = outs if isinstance(outs, tuple) else (outs,)
        given = seen[-1]
        assert given["q"].shape[-1] == (104 if padded else 64)
        assert all(not tfa.needs_padding(given[n]) for n in ("q", "k", "v"))
        if entry != "flash_forward":
            assert given["dout"].shape[-1] == given["q"].shape[-1]
        if not padded:
            assert given["q"] is q and given["k"] is k and given["v"] is v
        assert all(o.shape == q.shape for o in outs)
    assert getattr(tfa, entry).launches == 2
