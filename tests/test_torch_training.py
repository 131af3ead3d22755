"""The port's training path (training/trainer.py, ema.py, lora.py, loop.py)
against the JAX package's training/, on the CPU at tiny widths, with the
same numpy-drawn weights in both (torch_port_util.tiny_control_nets).

The loss runs at 32x32 latents and 256x256 hints, so that the level-0
transformer blocks have 1024 tokens and the port's attention goes through
its autograd Function there (the JAX side with flash_attention off: its
plain reference). The JAX gradient trees go to the port's names by
checkpoint/convert.py's map, which is linear in the weights.

Tolerances, each per tensor relative to that tensor's max |reference|:
  * fp32 loss 1e-5, gradients 1e-4 (summation order; seen: 8e-6);
  * bf16 (both packages in bf16, the same fp32 masters): the loss within
    one bf16 ulp (2^-8 relative) of the JAX bf16 loss; each gradient within
    8 bf16 ulps of the fp32 gradient, and the median over tensors no
    further from it than the JAX bf16 gradients' median (seen: the port's
    1.2% median and 2.3% max off the fp32 gradients, JAX's 8% and 19%: the
    port's attention backward and softmax run in fp32);
  * the AdamW step against optax on the same gradients 1e-6, EMA 1e-7;
  * after one train step at lr 1e-3, every parameter whose JAX gradient is
    above 1e-3 of its tensor's max within 1e-6 (absolute) of the JAX
    parameter, and every one within 2 lr (an element whose gradient is
    within the summation noise of zero may step either way: the first AdamW
    step is lr x g / |g|);
  * resume and remat: equal in bytes (the same CPU kernels in the same
    order).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from stablediffusioneo_tpu.ops import dispatch as jax_dispatch
from stablediffusioneo_tpu.training import ema as jema
from stablediffusioneo_tpu.training import lora as jlora
from stablediffusioneo_tpu.training import trainer as jt
from stablediffusioneo_tpu_torch.ops.kernels import attention as ka
from stablediffusioneo_tpu_torch.training import ema as pema
from stablediffusioneo_tpu_torch.training import lora as plora
from stablediffusioneo_tpu_torch.training import loop as ploop
from stablediffusioneo_tpu_torch.training import trainer as pt

from torch_port_util import CFG, PORT_CFG, assert_trees_close, port_names, tiny_control_nets

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BF16_ULP = 2.0 ** -8
LR = 1e-3


@pytest.fixture(scope="module")
def nets():
    return tiny_control_nets(seed=0)


@pytest.fixture(scope="module")
def jax_plain():
    """The JAX package with its attention on the plain reference."""
    was = jax_dispatch.kernels_enabled("flash_attention")
    jax_dispatch.set_kernels(flash_attention=False)
    yield
    jax_dispatch.set_kernels(flash_attention=was)


def _batch(b=1, seed=0):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((b, 32, 32, 4), dtype=np.float32),
            "hint": rng.random((b, 256, 256, 3), dtype=np.float32),
            "ctx": rng.standard_normal((b, CFG.clip.max_length, CFG.unet.context_dim),
                                       dtype=np.float32)}


def _draws(b=1, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1000, b).astype(np.int32),
            rng.standard_normal((b, 32, 32, 4), dtype=np.float32))


def _cfgs(dtype):
    return dataclasses.replace(CFG, dtype=dtype), dataclasses.replace(PORT_CFG, dtype=dtype)


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_JITTED = {}


def _jax_value_and_grad(cfg):
    if cfg.dtype not in _JITTED:
        _JITTED[cfg.dtype] = jax.jit(jax.value_and_grad(jt.diffusion_loss), static_argnums=(2,))
    return _JITTED[cfg.dtype]


def _port_loss_and_grads(nets, pcfg, batch, t, noise):
    state, _ = pt.create_train_state(nets["controlnet"][1], LR)
    sa, s1 = pt.make_schedule_buffers(pcfg, "cpu")
    b = _torch(batch)
    loss = pt.diffusion_loss(state.net, pt.frozen(nets["unet"][1], pcfg.dtype), pcfg, sa, s1,
                             b["x0"], b["hint"], b["ctx"], torch.from_numpy(t).long(),
                             torch.from_numpy(noise), controlnet_params=state.params)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in state.params.items()}


def _jax_loss_and_grads(nets, jcfg, batch, t, noise):
    sa, s1 = jt.make_schedule_buffers(jcfg)
    loss, grads = _jax_value_and_grad(jcfg)(
        nets["controlnet"][0], nets["unet"][0], jcfg, sa, s1, batch["x0"], batch["hint"],
        batch["ctx"], jnp.asarray(t), noise)
    return float(loss), port_names("controlnet", grads)


def test_diffusion_loss_and_grads_match_jax_fp32(nets, jax_plain, monkeypatch):
    """fp32: the loss and every ControlNet gradient; the port's backward ran
    through the attention Function at each 1024-token site that needs a
    gradient (the ControlNet's level-0 transformer and the UNet's two
    level-0 decoder transformers, self and cross: 6; the UNet encoder's
    carries none)."""
    calls = []
    real = ka.packed_bwd
    monkeypatch.setattr(ka, "packed_bwd", lambda q, *a: calls.append(q.shape) or real(q, *a))
    jcfg, pcfg = _cfgs("float32")
    batch, (t, noise) = _batch(), _draws()
    loss, grads = _port_loss_and_grads(nets, pcfg, batch, t, noise)
    j_loss, j_grads = _jax_loss_and_grads(nets, jcfg, batch, t, noise)
    assert abs(loss - j_loss) <= LOSS_TOL * abs(j_loss)
    assert_trees_close(grads, j_grads, GRAD_TOL)
    assert len(calls) == 6 and all(s[1] == 1024 for s in calls)


def test_diffusion_loss_and_grads_match_jax_bf16(nets, jax_plain):
    """bf16 in both packages, the same fp32 masters (tolerances above)."""
    batch, (t, noise) = _batch(), _draws()
    ref = _jax_loss_and_grads(nets, _cfgs("float32")[0], batch, t, noise)[1]
    jcfg, pcfg = _cfgs("bfloat16")
    loss, grads = _port_loss_and_grads(nets, pcfg, batch, t, noise)
    j_loss, j_grads = _jax_loss_and_grads(nets, jcfg, batch, t, noise)
    assert abs(loss - j_loss) <= BF16_ULP * abs(j_loss)
    port_errs, jax_errs = [], []
    for name, want in ref.items():
        scale = want.abs().max().item()
        port_errs.append((grads[name] - want).abs().max().item() / scale)
        jax_errs.append((j_grads[name] - want).abs().max().item() / scale)
        assert port_errs[-1] <= 8 * BF16_ULP, (name, port_errs[-1])
    assert np.median(port_errs) <= np.median(jax_errs)


def test_train_step_matches_jax(nets, jax_plain):
    """One train_step at lr 1e-3 with the JAX step's own draws handed in
    (t, noise from split(fold_in(key, 0))): the loss, the gradients the step
    took, the parameters after AdamW, and the step counter."""
    jcfg, pcfg = _cfgs("float32")
    batch = _batch(b=2, seed=4)
    key = jax.random.PRNGKey(7)
    kt, kn = jax.random.split(jax.random.fold_in(key, 0))
    t = np.array(jax.random.randint(kt, (2,), 0, jcfg.diffusion.timesteps))
    noise = np.array(jax.random.normal(kn, batch["x0"].shape, jnp.float32))

    j_state, tx = jt.create_train_state(nets["controlnet"][0], LR)
    sa, s1 = jt.make_schedule_buffers(jcfg)
    step = jax.jit(functools.partial(jt.train_step, tx=tx, cfg=jcfg))
    j_state, j_loss = step(j_state, unet_params=nets["unet"][0], sqrt_abar=sa,
                           sqrt_one_minus_abar=s1,
                           batch={k: jnp.asarray(v) for k, v in batch.items()}, key=key)
    j_grads = _jax_loss_and_grads(nets, jcfg, batch, t, noise)[1]

    state, p_tx = pt.create_train_state(nets["controlnet"][1], LR)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    psa, ps1 = pt.make_schedule_buffers(pcfg, "cpu")
    state, loss = pt.train_step(state, p_tx, nets["unet"][1], pcfg, psa, ps1, _torch(batch),
                                key=7, t=torch.from_numpy(t).long(),
                                noise=torch.from_numpy(noise))
    assert state.step == 1 and int(j_state.step) == 1
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    assert_trees_close({n: p.grad for n, p in state.params.items()}, j_grads, GRAD_TOL)
    want = port_names("controlnet", j_state.params)
    for name, ref in want.items():
        got, g = state.params[name].detach(), j_grads[name].abs()
        sure = g > 1e-3 * g.max()
        assert (got - ref)[sure].abs().max() <= 1e-6, name
        assert (got - ref).abs().max() <= 2 * LR, name
        assert not torch.equal(got, before[name]), name


def test_adamw_step_matches_optax():
    """torch.optim.AdamW as create_train_state makes it against
    optax.adamw(lr, weight_decay=0.01), three steps on the same gradients."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((64, 32), dtype=np.float32),
              "b": rng.standard_normal(32, dtype=np.float32)}
    net = torch.nn.Linear(32, 64)
    state, tx = pt.create_train_state(net, LR, params={k: torch.from_numpy(v.copy())
                                                       for k, v in params.items()})
    j_tx = optax.adamw(LR, weight_decay=0.01)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_opt = j_tx.init(j_params)
    for i in range(3):
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in params.items()}
        updates, j_opt = j_tx.update({k: jnp.asarray(v) for k, v in grads.items()}, j_opt,
                                     j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in state.params.items():
            p.grad = torch.from_numpy(grads[k])
        tx.step()
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=0, atol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((8, 8), dtype=np.float32),
            "b": {"c": rng.standard_normal(5, dtype=np.float32)}}
    j_state = jema.ema_init(jax.tree.map(jnp.asarray, tree))
    p_state = pema.ema_init(jax.tree.map(torch.from_numpy, tree))
    for i in range(4):
        params = jax.tree.map(lambda x: x + np.float32(i + 1), tree)
        j_state = jema.ema_update(j_state, jax.tree.map(jnp.asarray, params), 0.99)
        p_state = pema.ema_update(p_state, jax.tree.map(torch.from_numpy, params), 0.99)
    assert p_state[1] == int(j_state[1]) == 4
    np.testing.assert_allclose(p_state[0]["a"].numpy(), np.asarray(j_state[0]["a"]), atol=1e-7)
    np.testing.assert_allclose(p_state[0]["b"]["c"].numpy(), np.asarray(j_state[0]["b"]["c"]),
                               atol=1e-7)


def _nonzero_lora(tree, seed=5):
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4096))
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x if p[-1].key != "b" else
        jax.random.normal(next(keys), x.shape, x.dtype) * 0.1, tree)


@pytest.mark.parametrize("on", ["controlnet", "unet"])
def test_lora_train_step_matches_jax(nets, jax_plain, on):
    """lora_train_step on the ControlNet and on the UNet: the same adapter
    sites, loss and factor gradients as the JAX package's (its loss_fn:
    merge_lora inside diffusion_loss), the factors stepped as JAX's
    lora_train_step steps them, and both frozen networks unchanged in
    bytes."""
    jcfg, pcfg = _cfgs("float32")
    trees = {"controlnet": nets["controlnet"][0], "unet": nets["unet"][0]}
    lora = _nonzero_lora(jlora.init_lora(jax.random.PRNGKey(1), trees[on], rank=4))
    batch = _batch(seed=6)
    key = jax.random.PRNGKey(3)
    kt, kn = jax.random.split(jax.random.fold_in(key, 0))
    t = np.array(jax.random.randint(kt, (1,), 0, 1000))
    noise = np.array(jax.random.normal(kn, batch["x0"].shape, jnp.float32))
    sa, s1 = jt.make_schedule_buffers(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(lo):
        merged = dict(trees, **{on: jlora.merge_lora(trees[on], lo, 1.0)})
        return jt.diffusion_loss(merged["controlnet"], merged["unet"], jcfg, sa, s1, jb["x0"],
                                 jb["hint"], jb["ctx"], jnp.asarray(t), jnp.asarray(noise))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(lora)
    j_state, tx = jt.create_train_state(lora, LR)
    step = jax.jit(functools.partial(jlora.lora_train_step, tx=tx, cfg=jcfg, on=on,
                                     scale=1.0))
    j_state, _ = step(j_state, frozen=trees, sqrt_abar=sa, sqrt_one_minus_abar=s1, batch=jb,
                      key=key)

    port = {"controlnet": nets["controlnet"][1], "unet": nets["unet"][1]}
    assert plora.lora_sites(port[on]) == jlora.lora_sites(trees[on])
    frozen_before = {(k, n): v.clone() for k, net in port.items()
                     for n, v in net.state_dict().items()}
    tree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), lora)
    state, p_tx = pt.create_train_state(port[on], LR, params=tree)
    psa, ps1 = pt.make_schedule_buffers(pcfg, "cpu")
    state, loss = plora.lora_train_step(
        state, p_tx, port, pcfg, psa, ps1, _torch(batch), key=3, on=on,
        t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise))
    assert abs(loss.item() - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
    flat = lambda tr: {"/".join(map(str, p)): v for p, v in
                       ((tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path), leaf)
                        for path, leaf in jax.tree_util.tree_leaves_with_path(tr))}
    grads = flat(jax.tree.map(lambda x: x.grad, state.params))
    assert_trees_close(grads, {k: np.asarray(v) for k, v in flat(j_grads).items()}, GRAD_TOL)
    stepped = flat(state.params)
    for name, ref in flat(j_state.params).items():
        np.testing.assert_allclose(stepped[name].detach().numpy(), np.asarray(ref), rtol=0,
                                   atol=2 * LR, err_msg=name)
    assert all(torch.equal(v, frozen_before[(k, n)]) for k, net in port.items()
               for n, v in net.state_dict().items())


def _run(nets, steps, restore_after=None, tmp_path=None):
    """`steps` train steps on seeded batches with the port's own draws; with
    restore_after=n, the state is saved after step n and the rest runs on a
    fresh state restored from the file."""
    state, tx = pt.create_train_state(nets["controlnet"][1], LR)
    sa, s1 = pt.make_schedule_buffers(PORT_CFG, "cpu")
    unet = nets["unet"][1]
    for i in range(steps):
        if i == restore_after:
            path = str(tmp_path / "ckpt" / "state.pt")
            ploop.save_checkpoint(path, state)
            state, tx = pt.create_train_state(nets["controlnet"][1], LR)
            state = ploop.restore_checkpoint(path, state)
            assert state.step == restore_after
        b = _torch(next(_batches(seed=10 + i)))
        state, loss = pt.train_step(state, tx, unet, PORT_CFG, sa, s1, b, key=21)
    return state


def test_resume_equals_uninterrupted_steps(nets, tmp_path):
    """Save after step 1, restore into a fresh state, take step 2: the
    params and both AdamW moments equal two uninterrupted steps in bytes
    (the step's draws come from (key, step), so the resumed step draws what
    the uninterrupted one does)."""
    a = _run(nets, 2)
    b = _run(nets, 2, restore_after=1, tmp_path=tmp_path)
    assert a.step == b.step == 2
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
    sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
    for i in sa:
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][moment], sb[i][moment])


def test_step_draws_follow_key_and_step():
    x0 = torch.zeros(3, 4, 4, 4)
    t1, n1 = pt.step_draws(5, 2, x0, 1000)
    t2, n2 = pt.step_draws(5, 2, x0, 1000)
    t3, n3 = pt.step_draws(5, 3, x0, 1000)
    assert torch.equal(t1, t2) and torch.equal(n1, n2)
    assert not torch.equal(n1, n3)
    assert t1.shape == (3,) and int(t1.min()) >= 0 and int(t1.max()) < 1000


def _batches(seed=30):
    rng = np.random.default_rng(seed)
    while True:
        yield {"x0": rng.standard_normal((2, 8, 8, 4), dtype=np.float32),
               "hint": (rng.random((2, 64, 64, 3)) * 255).astype(np.uint8),
               "ctx": rng.standard_normal((2, 16, CFG.unet.context_dim), dtype=np.float32)}


@pytest.mark.parametrize("lora_rank", [None, 2])
def test_train_two_steps_with_metrics(nets, tmp_path, lora_rank):
    """train() for 2 steps on the CPU: a JSONL line a step, the trained
    tensors moved (the ControlNet's, or the adapters' "b" factors), the EMA
    kept, a checkpoint written at ckpt_every, the networks given unchanged."""
    control = nets["controlnet"][1]
    before = {k: v.clone() for k, v in control.state_dict().items()}
    metrics = tmp_path / "m.jsonl"
    state = ploop.train(PORT_CFG, nets["unet"][1], control, _batches(), num_steps=2,
                        learning_rate=LR, seed=1, metrics_path=str(metrics),
                        ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, lora_rank=lora_rank,
                        device="cpu")
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1] and all(np.isfinite(r["loss"]) for r in lines)
    assert state.step == 2 and (tmp_path / "ck" / "step_000000002.pt").exists()
    assert all(torch.equal(v, before[k]) for k, v in control.state_dict().items())
    if lora_rank:
        assert plora.n_sites(state.params) == len(plora.lora_sites(control))
        moved = [not torch.equal(s["b"], torch.zeros_like(s["b"]))
                 for s in (plora._get(state.params, p) for p in plora._site_paths(state.params))]
        assert all(moved)
    else:
        assert any(not torch.equal(p, before[n]) for n, p in state.params.items())
    assert state.ema is not None and state.ema.keys() == state.params.keys()


@pytest.mark.parametrize("mesh", [{"dp": 2}, {"tp": 2}, {"fsdp": True}])
def test_train_refuses_a_mesh(nets, mesh):
    """dp, tp and fsdp train on a mesh of a torch.distributed process group
    (tests/test_torch_parallel.py); without one, train() says so."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        ploop.train(PORT_CFG, nets["unet"][1], nets["controlnet"][1], _batches(), 1,
                    device="cpu", metrics_path=None, **mesh)
