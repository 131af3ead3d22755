"""Autograd through the port's kernel entries, fp32 on the CPU, against the
JAX package's VJPs (ops/pallas/attention.py `_packed_bwd` / `_split_bwd`,
called directly as tests/test_pallas_kernels.py does, and
ops/pallas/layernorm.py `_ln_bwd`) and against autograd through the port's
plain versions; the GroupNorm and int8 entries, which have no VJP in the
JAX package, raise under grad; the remat flag gives the same gradients.

Tolerances, fp32 (the two sides differ in summation order only): outputs
and gradients within 2e-5 x max |reference| per tensor where the port's
backward is the plain version's VJP (one-shot path), 1e-4 on the chunked
path (a running max and sum of exponentials over chunks against one
softmax), and the remat gradients equal in bytes (the same CPU kernels in
the same order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.ops.pallas import attention as pa
from stablediffusioneo_tpu.ops.pallas import layernorm as pln
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
from stablediffusioneo_tpu_torch.ops.kernels import groupnorm as kg
from stablediffusioneo_tpu_torch.ops.kernels import layernorm as kl
from stablediffusioneo_tpu_torch.ops.kernels import quant as kq
from stablediffusioneo_tpu_torch.ops.norms import group_norm, layer_norm
from stablediffusioneo_tpu_torch.ops.quant import quantize_weights, quantized_linear

from torch_port_util import PORT_CFG, assert_close_scaled, tiny_control_nets

ONE_SHOT_TOL, CHUNKED_TOL = 2e-5, 1e-4
HEADS, D = 2, 16


def _draw(rng, *shapes):
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _grads(fn, arrays, g):
    """(out, grads) of fn on tensors of `arrays` that require grad, with the
    cotangent g."""
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return out.detach(), [x.grad for x in xs]


def _tol(s):
    return CHUNKED_TOL if ka._chunked(s) else ONE_SHOT_TOL


@pytest.mark.parametrize("stream", [False, True], ids=["packed", "stream"])
@pytest.mark.parametrize("tq,s", [(1024, 77), (1024, 1024), (256, 1536), (128, 2048)])
def test_packed_entry_gradients_match_jax(tq, s, stream):
    """The packed entries under autograd: one-shot at S = 77 and 1024, the
    chunked recurrence at S = 1536 and 2048; against the JAX `_packed_bwd`
    on the JAX `_packed_math` output, and against autograd through the
    port's plain version."""
    rng = np.random.default_rng(s)
    c = HEADS * D
    q, k, v, g = _draw(rng, (2, tq, c), (2, s, c), (2, s, c), (2, tq, c))
    scale = D ** -0.5
    entry = ka.fused_attention_packed_stream if stream else ka.fused_attention_packed
    out, grads = _grads(lambda a, b, c_: entry(a, b, c_, HEADS, scale), (q, k, v), g)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    j_out = pa._packed_math(jq, jk, jv, HEADS, scale)
    want = pa._packed_bwd(HEADS, scale, True, False, (jq, jk, jv, j_out), jg)
    assert_close_scaled(out.numpy(), np.asarray(j_out), ONE_SHOT_TOL)
    for got, ref in zip(grads, want):
        assert_close_scaled(got.numpy(), np.asarray(ref), _tol(s))
    _, plain = _grads(lambda a, b, c_: ka.fused_attention_packed_plain(a, b, c_, HEADS, scale),
                      (q, k, v), g)
    for got, ref in zip(grads, plain):
        assert_close_scaled(got.numpy(), ref.numpy(), _tol(s))


@pytest.mark.parametrize("tq,s", [(1024, 77), (1024, 1024), (128, 2048)])
def test_split_entry_gradients_match_jax(tq, s):
    rng = np.random.default_rng(s + 1)
    q, k, v, g = _draw(rng, (1, HEADS, tq, D), (1, HEADS, s, D), (1, HEADS, s, D),
                       (1, HEADS, tq, D))
    scale = D ** -0.5
    out, grads = _grads(lambda a, b, c_: ka.fused_attention(a, b, c_, scale), (q, k, v), g)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    j_out = pa._split_math(jq, jk, jv, scale)
    want = pa._split_bwd(scale, True, False, (jq, jk, jv, j_out), jg)
    assert_close_scaled(out.numpy(), np.asarray(j_out), ONE_SHOT_TOL)
    for got, ref in zip(grads, want):
        assert_close_scaled(got.numpy(), np.asarray(ref), _tol(s))
    _, plain = _grads(lambda a, b, c_: ka.fused_attention_plain(a, b, c_, scale), (q, k, v), g)
    for got, ref in zip(grads, plain):
        assert_close_scaled(got.numpy(), ref.numpy(), _tol(s))


def test_chunked_backward_is_what_long_keys_take(monkeypatch):
    """S = 2048 goes through attn_bwd_chunked, S = 1024 does not (the JAX
    rule: S > 1024 and S % 512 == 0), and the entries run through their
    autograd Functions only under grad."""
    calls = []
    real = ka.attn_bwd_chunked
    monkeypatch.setattr(ka, "attn_bwd_chunked", lambda *a: calls.append(a[1].shape) or real(*a))
    rng = np.random.default_rng(0)
    for s in (1024, 2048, 1536 + 7):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in
                   _draw(rng, (1, 64, 32), (1, s, 32), (1, s, 32)))
        out = ka.fused_attention_packed(q, k, v, HEADS, 0.25)
        assert type(out.grad_fn).__name__ == "_PackedAttentionBackward"
        out.sum().backward()
    assert calls == [(1, HEADS, 2048, D)]
    with torch.no_grad():
        assert ka.fused_attention_packed(q, k, v, HEADS, 0.25).grad_fn is None
    assert ka.fused_attention_packed(q.detach(), k.detach(), v.detach(), HEADS,
                                     0.25).grad_fn is None


def test_fused_qkv_views_get_gradients_of_their_shapes():
    """multi_head_attention hands the entry column views of one fused QKV
    output: the Function's gradients have the views' shapes, and autograd
    assembles them into the projection's gradient, as through the plain
    version."""
    from stablediffusioneo_tpu_torch.ops.layers import linear

    rng = np.random.default_rng(3)
    x_np, w_np = _draw(rng, (2, 1024, 32), (96, 32))
    grads = []
    for entry in (ka.fused_attention_packed, ka.fused_attention_packed_plain):
        x, w = torch.from_numpy(x_np), torch.from_numpy(w_np).requires_grad_()
        q, k, v = linear(x, w).chunk(3, dim=-1)
        entry(q, k, v, HEADS, D ** -0.5).square().sum().backward()
        grads.append(w.grad)
    assert grads[0].shape == (96, 32) and grads[0].abs().min() > 0
    assert_close_scaled(grads[0].numpy(), grads[1].numpy(), ONE_SHOT_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_gradients_match_jax(dtype):
    """fused_layer_norm under autograd against the JAX `_ln_bwd` (fp32), and
    ops/norms.py:layer_norm with the layernorm flag on, whose gate takes
    bf16 (2048 x 320: 640K elements), through the Function."""
    rng = np.random.default_rng(5)
    x, g = _draw(rng, (2, 1024, 320), (2, 1024, 320))
    w, b = 1 + 0.1 * rng.standard_normal(320, dtype=np.float32), \
        0.1 * rng.standard_normal(320, dtype=np.float32)
    if dtype == torch.float32:
        out, grads = _grads(lambda a, w_, b_: kl.fused_layer_norm(a, w_, b_, 1e-5),
                            (x, w, b), g)
        want = pln._ln_bwd(1e-5, True, (x, w, b), g)
        assert_close_scaled(out.numpy(), np.asarray(pln._ln_math(x, w, b, 1e-5)), ONE_SHOT_TOL)
        for got, ref in zip(grads, want):
            assert_close_scaled(got.numpy(), np.asarray(ref), ONE_SHOT_TOL)
        return
    xs = torch.from_numpy(x).to(dtype).requires_grad_()
    ws, bs = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    dispatch.set_kernels(layernorm=True)
    try:
        out = layer_norm(xs, ws, bs, 1e-5)
    finally:
        dispatch.set_kernels(layernorm=False)
    assert type(out.grad_fn).__name__ == "_LayerNormBackward"
    out.backward(torch.from_numpy(g).to(dtype))
    want = [dispatch.vjp(lambda a, w_, b_: kl.fused_layer_norm_plain(a, w_, b_, 1e-5),
                         (xs, ws, bs), torch.from_numpy(g).to(dtype))]
    for got, ref in zip((xs.grad, ws.grad, bs.grad), want[0]):
        assert torch.equal(got, ref)


def _gn_inputs(requires_grad):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16, 16), dtype=np.float32))
    w, b = torch.ones(32), torch.zeros(32)
    return x.requires_grad_(requires_grad), w, b


@pytest.mark.parametrize("entry", ["fused_group_norm", "group_norm_stats", "group_norm_apply",
                                   "group_norm (flag on)"])
def test_group_norm_entries_refuse_gradients(entry):
    """The JAX package defines no VJP for its GroupNorm kernels, so the
    port's entries raise under grad (never a detached output); without grad
    they run."""
    def call(x, w, b):
        if entry == "fused_group_norm":
            return kg.fused_group_norm(x, w, b, 8, 1e-5, True)
        if entry == "group_norm_stats":
            return kg.group_norm_stats(x, 8, 64)
        if entry == "group_norm_apply":
            parts = kg.group_norm_stats_plain(x.detach(), 8, 64)
            return kg.group_norm_apply(x, parts, w, b, 64, 1e-5, True)
        dispatch.set_kernels(groupnorm=True)
        try:
            return group_norm(x, w, b, 8, 1e-5, swish=True)
        finally:
            dispatch.set_kernels(groupnorm=False)

    with pytest.raises(RuntimeError, match="has no gradient"):
        call(*_gn_inputs(True))
    with torch.no_grad():
        assert torch.isfinite(call(*_gn_inputs(True))).all()
    assert torch.isfinite(call(*_gn_inputs(False))).all()


def test_jax_group_norm_kernel_has_no_gradient():
    """What the refusal mirrors: jax.grad through the Pallas GroupNorm (in
    interpret mode) fails."""
    from stablediffusioneo_tpu.ops.pallas.groupnorm import fused_group_norm

    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 8, 8, 32), dtype=np.float32))
    g, b = jnp.ones(32), jnp.zeros(32)
    with pytest.raises(Exception, match="Linearization failed|differentiat|JVP"):
        jax.grad(lambda a: fused_group_norm(a, g, b, 8, interpret=True).sum())(x)


@pytest.mark.parametrize("entry", ["quantized_matmul", "quantized_linear (flag on)"])
def test_int8_matmul_refuses_gradients(entry):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((16, 64), dtype=np.float32))
    w_q, scale = quantize_weights(torch.from_numpy(rng.standard_normal((128, 64),
                                                                       dtype=np.float32)))

    def call(x):
        if entry == "quantized_matmul":
            return kq.quantized_matmul(x, w_q, scale)
        dispatch.set_kernels(int8_linear=True)
        try:
            return quantized_linear(x, w_q, scale)
        finally:
            dispatch.set_kernels(int8_linear=False)

    with pytest.raises(RuntimeError, match="has no gradient"):
        call(x.clone().requires_grad_())
    assert call(x).shape == (16, 128)


@pytest.fixture(scope="module")
def nets():
    return tiny_control_nets(seed=3)


def test_remat_gives_the_same_gradients(nets, monkeypatch):
    """set_kernels(remat=True): the diffusion loss's ControlNet gradients
    equal those without remat, in bytes, and the blocks whose activations
    a gradient needs ran their forward twice (the UNet encoder's blocks
    have no such input and run once); the flag is in kernel_flags()."""
    from stablediffusioneo_tpu_torch.models.unet import ResBlock
    from stablediffusioneo_tpu_torch.training import trainer

    unet, control = nets["unet"][1], nets["controlnet"][1]
    rng = np.random.default_rng(11)
    x0, noise = (torch.from_numpy(a) for a in _draw(rng, (2, 8, 8, 4), (2, 8, 8, 4)))
    hint = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 16, PORT_CFG.unet.context_dim),
                                               dtype=np.float32))
    t = torch.tensor([100, 700])
    sa, s1 = trainer.make_schedule_buffers(PORT_CFG, "cpu")
    calls = []
    real = ResBlock._forward
    monkeypatch.setattr(ResBlock, "_forward", lambda self, *a: calls.append(1) or real(self, *a))
    grads = []
    for remat in (False, True):
        state, _ = trainer.create_train_state(control)
        dispatch.set_kernels(remat=remat)
        try:
            assert ("remat", remat) in dispatch.kernel_flags()
            calls.clear()
            loss = trainer.diffusion_loss(control, unet, PORT_CFG, sa, s1, x0, hint, ctx, t,
                                          noise, controlnet_params=state.params)
            forward_calls = len(calls)
            loss.backward()
        finally:
            dispatch.set_kernels(remat=False)
        grads.append({n: p.grad for n, p in state.params.items()})
        recomputed = len(calls) - forward_calls
        n_unet_enc = sum(isinstance(m, ResBlock) for m in
                         list(unet.input_blocks.modules()) + list(unet.middle_block.modules()))
        assert recomputed == (forward_calls - n_unet_enc if remat else 0)
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name
