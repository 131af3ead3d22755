"""The port's engine layer (runtime/engine.py) against the JAX package's, fp32
on the CPU at tiny_pipeline() size, where an engine runs its function eagerly:
the runtime surface around the engines (buckets, per-sample scales, engine
names and the cache, seeds, report, warmup, release). What a capture adds is
held on the card (tests/test_torch_cuda.py)."""

import collections

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stablediffusioneo_tpu.runtime import engine as jax_engine
from stablediffusioneo_tpu_torch.ops import dispatch
from stablediffusioneo_tpu_torch.runtime import engine as port_engine

from torch_port_util import CFG, PORT_CFG, port_model, tiny_params


@pytest.fixture(scope="module")
def runtimes():
    params = tiny_params()
    return (jax_engine.CNSDRuntime(params, CFG, persistent_cache=False),
            port_engine.CNSDRuntime(port_model(params), PORT_CFG, device="cpu"))


@pytest.fixture
def rt(runtimes):
    """The port's runtime with an empty engine cache."""
    runtimes[1]._engines.clear()
    return runtimes[1]


def _inputs(batch=1, seed=5, res=64):
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((2 * batch, CFG.clip.max_length, CFG.unet.context_dim),
                              dtype=np.float32)
    hint = (rng.random((batch, res, res, 3)) > 0.7).astype(np.uint8) * 255
    x_T = rng.standard_normal((batch, res // 8, res // 8, 4), dtype=np.float32)
    t = torch.from_numpy
    return t(x_T), t(hint), t(ctx[:batch]), t(ctx[batch:])


@pytest.mark.parametrize("buckets", [None, (512, 256, 1024), (64,)])
def test_snap_to_bucket_matches_jax(buckets):
    kw = {} if buckets is None else {"buckets": buckets}
    assert port_engine.DEFAULT_BUCKETS == jax_engine.DEFAULT_BUCKETS
    assert port_engine.resolution_buckets(**kw) == jax_engine.resolution_buckets(**kw)
    for value in range(1, 1025):
        assert port_engine.snap_to_bucket(value, **kw) == \
            jax_engine.snap_to_bucket(value, **kw)


@pytest.mark.parametrize("guess_mode", [False, True])
@pytest.mark.parametrize("batch,scale,strength", [
    (1, 9.0, 1.0), (3, 7.5, 0.6), (3, [9.0, 5.0, 1.0], 0.8),
    (2, 4.0, [1.0, 0.25]), (2, [9.0, 2.0], [0.5, 1.5]),
])
def test_per_sample_scales_match_jax(runtimes, guess_mode, batch, scale, strength):
    jax_rt, port_rt = runtimes
    gs_ref, cs_ref = jax_rt._per_sample_scales(batch, scale, strength, guess_mode)
    gs, cs = port_rt._per_sample_scales(batch, scale, strength, guess_mode)
    assert gs.dtype == cs.dtype == torch.float32
    assert gs.shape == (batch,) and cs.shape == (batch, port_rt.n_taps)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(gs_ref))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(cs_ref))


# argument sets of the JAX sample_decode_engine, positional as it takes them:
# (num_steps, batch, h, w, guess_mode, sampler, encoder_cache_interval,
#  ctx_len, hint_u8, gen_xT, inpaint, cfg_rescale)
ENGINE_ARGS = [
    (2, 1, 64, 64),
    (3, 2, 64, 128, True),
    (2, 1, 64, 64, False, "ddim", 2),
    (2, 1, 64, 64, False, "ddim", 1, None, True),
    (2, 2, 64, 64, False, "ddim", 1, None, "packed"),
    (1, 1, 64, 64, False, "ddim", 1, None, True, "img2img"),
    (2, 1, 64, 64, False, "ddim", 1, None, False, False, True),
    (2, 1, 64, 64, False, "ddim", 1, None, False, False, False, 0.7),
    (2, 1, 128, 64, True, "ddim", 1, None, True, "img2img", True),
    (2, 1, 64, 64, False, "dpmpp-karras"),
    (3, 1, 64, 64, True, "euler-a-uniform", 1, None, True),
    (4, 2, 64, 64, False, "plms", 1, None, False, False, False, 0.7),
]


@pytest.mark.parametrize("args", ENGINE_ARGS, ids=[str(i) for i in range(len(ENGINE_ARGS))])
def test_engine_names_and_cache_match_jax(runtimes, rt, monkeypatch, args):
    """The same name string as the JAX engine of the same arguments (its AOT
    compile is skipped: only the name is read), one cache entry an argument
    set, and a second call returns the same object."""
    jax_rt = runtimes[0]
    monkeypatch.setattr(jax_engine.Engine, "load", lambda self, *a, **k: self)
    monkeypatch.setattr(jax_rt, "_engines", {})
    ref = jax_rt.sample_decode_engine(*args)
    eng = rt.sample_decode_engine(*args)
    assert eng.name == ref.name
    assert rt.sample_decode_engine(*args) is eng
    assert len(rt._engines) == 1
    assert not eng.compiled and eng.get_engine_infor() == {"compiled": False}
    # the sampler engine of the arguments it shares
    if len(args) <= 9 and (len(args) < 9 or args[8] in (False, True)):
        assert rt.sampler_engine(*args).name == jax_rt.sampler_engine(*args).name
        assert rt.sampler_engine(*args) is rt.sampler_engine(*args)
        assert len(rt._engines) == 2


def test_other_engine_names_and_keys(runtimes, rt, monkeypatch):
    jax_rt = runtimes[0]
    monkeypatch.setattr(jax_engine.Engine, "load", lambda self, *a, **k: self)
    monkeypatch.setattr(jax_rt, "_engines", {})
    assert rt.clip_engine(2).name == jax_rt.clip_engine(2).name == "clip_b2"
    assert rt.clip_engine(2, 2).name == jax_rt.clip_engine(2, 2).name
    assert rt.decoder_engine(1, 64, 128).name == jax_rt.decoder_engine(1, 64, 128).name
    for det in (False, True):
        eng = rt.encoder_engine(2, 64, 128, deterministic=det)
        assert eng.name == jax_rt.encoder_engine(2, 64, 128, deterministic=det).name
        assert rt.encoder_engine(2, 64, 128, deterministic=det) is eng
    # the JAX keys, with the capture flag and the kernel flags after them
    assert {k[:5] for k in rt._engines if k[0] == "encoder"} == \
        {k for k in jax_rt._engines if k[0] == "encoder"}
    assert rt.sampler_engine(2, 1, 64, 64, ctx_len=48).name == \
        jax_rt.sampler_engine(2, 1, 64, 64, ctx_len=48).name
    n = len(rt._engines)
    # the schedule is baked into a capture: eta and the tail are in the key
    a = rt.sample_decode_engine(2, 1, 64, 64)
    assert rt.sample_decode_engine(2, 1, 64, 64, eta=0.5) is not a
    assert rt.sample_decode_engine(2, 1, 64, 64, schedule_steps=4) is not a
    assert rt.sample_decode_engine(2, 1, 64, 64, schedule_steps=2) is a
    assert len(rt._engines) == n + 3
    # and so are the kernel flags, which change what a capture holds
    dispatch.set_kernels(groupnorm=True)
    try:
        assert rt.sample_decode_engine(2, 1, 64, 64) is not a
    finally:
        dispatch.set_kernels(groupnorm=False)
    assert rt.sample_decode_engine(2, 1, 64, 64) is a


@pytest.mark.parametrize("kwargs,error,match", [
    ({"hint_u8": "multi"}, ValueError, "multi-ControlNet"),
    ({"hint_u8": "multi", "sampler": "dpmpp"}, ValueError, "multi-ControlNet"),
    ({"hint_u8": "bits"}, ValueError, "unknown hint variant"),
    ({"gen_xT": "seeds"}, NotImplementedError, "outside the graph"),
    ({"gen_xT": True}, NotImplementedError, "outside the graph"),
])
def test_engine_variants_outside_the_port_raise(rt, kwargs, error, match):
    """The in-graph x_T variants stay outside the port (it draws x_T outside
    the graph, row by row with seeds=); the "multi" hint variant takes a
    multi-ControlNet runtime (a one-net runtime refuses it, as the JAX
    runtime refuses a tuple hint there)."""
    with pytest.raises(error, match=match):
        rt.sample_decode_engine(2, 1, 64, 64, **kwargs)


# sampler arguments the JAX runtime refuses: (sample_decode_engine keywords,
# sample_decode keywords the refusal needs there)
SAMPLER_REFUSALS = [
    ({"sampler": "dpmpp", "inpaint": True}, {}),
    ({"sampler": "heun-uniform", "encoder_cache_interval": 2}, {}),
    ({"sampler": "euler-a", "gen_xT": "img2img"}, {}),
    ({"sampler": "plms"}, {"eta": 0.5}),
    ({"sampler": "lms"}, {}),
    ({"sampler": "dpmpp-exponential"}, {}),
]


@pytest.mark.parametrize("engine_kw,call_kw", SAMPLER_REFUSALS,
                         ids=[str(i) for i in range(len(SAMPLER_REFUSALS))])
def test_sampler_refusals_match_jax(runtimes, rt, monkeypatch, engine_kw, call_kw):
    """Where the JAX runtime raises ValueError on a sampler and what it is
    combined with (its sample_decode_engine with the compile skipped, then
    its schedule), the port's sample_decode_engine raises ValueError with
    its words."""
    jax_rt = runtimes[0]
    monkeypatch.setattr(jax_engine.Engine, "load", lambda self, *a, **k: self)
    monkeypatch.setattr(jax_rt, "_engines", {})
    with pytest.raises(ValueError) as ref:
        jax_rt.sample_decode_engine(2, 1, 64, 64, **engine_kw)
        jax_rt._sched_device(2, engine_kw["sampler"], call_kw.get("eta", 0.0))
    with pytest.raises(ValueError) as got:
        rt.sample_decode_engine(2, 1, 64, 64, **engine_kw, **call_kw)
    assert str(got.value) == str(ref.value)
    assert rt._engines == {}


@pytest.mark.parametrize("sampler", ["ddim", "plms", "dpmpp", "dpmpp-karras", "unipc",
                                     "unipc-karras", "euler", "euler-uniform", "euler-a",
                                     "euler-a-uniform", "heun", "heun-uniform"])
def test_every_sampler_the_jax_package_accepts_runs(runtimes, rt, monkeypatch, sampler):
    """The twelve names: the JAX runtime builds an engine for each (compile
    skipped) under the same name, and the port's sample_decode gives finite
    uint8 images through it; a spacing is its own engine here, since the
    schedule is baked in, and eta is read by DDIM only."""
    jax_rt = runtimes[0]
    monkeypatch.setattr(jax_engine.Engine, "load", lambda self, *a, **k: self)
    monkeypatch.setattr(jax_rt, "_engines", {})
    x_T, hint, ctx_c, ctx_u = _inputs()
    img = rt.sample_decode(2, x_T, hint, ctx_c, ctx_u, sampler=sampler,
                           generator=torch.Generator().manual_seed(0))
    assert img.dtype == torch.uint8 and img.shape == (1, 64, 64, 3)
    assert torch.isfinite(rt.last_latents).all()
    (key, eng), = rt._engines.items()
    assert key[1] == sampler
    assert eng.name == jax_rt.sample_decode_engine(2, 1, 64, 64, False, sampler).name
    if sampler != "ddim":  # no second engine for an eta the loop does not read
        again = rt.sample_decode(2, x_T, hint, ctx_c, ctx_u, sampler=sampler, eta=0.0
                                 if sampler == "plms" else 0.7,
                                 generator=torch.Generator().manual_seed(0))
        assert len(rt._engines) == 1 and torch.equal(again, img)


def test_sampler_engines_are_keyed_by_spacing_and_tome(rt):
    """The schedule and the merge settings are baked into a capture, so the
    key holds the whole sampler string and the ToMe ratio: "dpmpp-karras"
    does not replay "dpmpp"'s loop, nor tome_ratio 0.5 the plain one."""
    a = rt.sample_decode_engine(2, 1, 64, 64, sampler="dpmpp")
    b = rt.sample_decode_engine(2, 1, 64, 64, sampler="dpmpp-karras")
    c = rt.sample_decode_engine(2, 1, 64, 64, sampler="dpmpp", tome_ratio=0.5)
    assert len({id(a), id(b), id(c)}) == 3 and a.name == b.name == c.name
    x_T, hint, ctx_c, ctx_u = _inputs()
    z = [rt.sample(2, x_T, hint, ctx_c, ctx_u, sampler=s) for s in ("dpmpp", "dpmpp-karras")]
    assert not torch.equal(z[0], z[1])


@pytest.mark.parametrize("seeds", [None, [11]])
def test_euler_a_noise_is_drawn_outside_the_loop(rt, seeds):
    """Euler-a's step noise is an engine input (steps, B, h, w, 4) drawn from
    generator= (or seeds= row by row) before the call, as DDIM's eta noise;
    handed in as noise= it gives the same latents; the last step, to sigma
    0, draws none."""
    x_T, hint, ctx_c, ctx_u = _inputs()
    gen = torch.Generator().manual_seed(4)
    kw = dict(sampler="euler-a", seeds=seeds) if seeds else dict(sampler="euler-a")
    first = None if seeds else x_T
    spec, args = rt._loop_inputs(3, first, hint, ctx_c, ctx_u, 9.0, 1.0, 0.0, False, gen,
                                 None, None, None, None, 1, 0.0, None, None, None, seeds,
                                 "euler-a")
    noise = args[6]
    assert noise.shape == (3, 1, 8, 8, 4) and noise[:2].abs().sum() > 0
    assert torch.equal(noise[2], torch.zeros_like(noise[2]))
    z = rt.sample(3, args[0] if seeds else x_T, hint, ctx_c, ctx_u, noise=list(noise),
                  sampler="euler-a")
    again = rt.sample(3, None if seeds else x_T, hint, ctx_c, ctx_u,
                      generator=torch.Generator().manual_seed(4), **kw)
    assert torch.equal(z, again)
    other = rt.sample(3, x_T, hint, ctx_c, ctx_u, sampler="euler-a",
                      generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other, z)


@pytest.mark.parametrize("kwargs", [
    {}, {"eta": 0.5}, {"guess_mode": True, "strength": 0.7},
    {"encoder_cache_interval": 2}, {"cfg_rescale": 0.7},
], ids=["default", "eta", "guess", "enc_cache", "cfg_rescale"])
def test_fused_sample_decode_equals_granular_path(rt, kwargs):
    """sample_decode against sample then decode_latent on the same inputs and
    noise: equal bytes, the same latents left in last_latents."""
    x_T, hint, ctx_c, ctx_u = _inputs()
    gen = lambda: torch.Generator().manual_seed(3)
    z = rt.sample(3, x_T, hint, ctx_c, ctx_u, generator=gen(), **kwargs)
    img = rt.decode_latent(z)
    fused = rt.sample_decode(3, x_T, hint, ctx_c, ctx_u, generator=gen(), **kwargs)
    assert fused.dtype == torch.uint8 and fused.shape == (1, 64, 64, 3)
    assert np.array_equal(fused.numpy(), img)
    assert torch.equal(rt.last_latents, z)
    assert torch.equal(rt.decode_latent_device(z), fused)


def test_fused_img2img_variant_equals_granular_path(rt):
    x_T, hint, ctx_c, ctx_u = _inputs()
    renoise = torch.randn(x_T.shape, generator=torch.Generator().manual_seed(2))
    kw = dict(init_latent=x_T, t_enc=2, renoise=renoise)
    z = rt.sample(4, None, hint, ctx_c, ctx_u, **kw)
    fused = rt.sample_decode(4, None, hint, ctx_c, ctx_u, **kw)
    assert np.array_equal(fused.numpy(), rt.decode_latent(z))
    names = sorted(e.name for e in rt._engines.values())
    assert names == ["ddim+decode_2x1x64x64_genxT-img2img", "ddim_2x1x64x64",
                     "decoder_b1_64x64"]
    # drawn from a generator instead: another image, the same one twice
    g = lambda: torch.Generator().manual_seed(7)
    a = rt.sample_decode(4, None, hint, ctx_c, ctx_u, init_latent=x_T, t_enc=2,
                         generator=g())
    b = rt.sample_decode(4, None, hint, ctx_c, ctx_u, init_latent=x_T, t_enc=2,
                         generator=g())
    assert torch.equal(a, b) and not torch.equal(a, fused)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("img2img", [False, True])
def test_per_sample_seeds_do_not_depend_on_the_batch(rt, eta, img2img):
    """seeds=: each row's x_T (or re-noise) and eta noise come from that
    row's own generator, so a row of a batch of three has the latents it has
    alone; with eta > 0 its step noise is part of that."""
    _, hint, ctx_c, ctx_u = _inputs(batch=3)
    seeds = [11, 12, 13]
    kw = dict(eta=eta, guidance_scale=[9.0, 5.0, 7.0], strength=[1.0, 0.5, 0.8])
    z0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 8, 8, 4), dtype=np.float32))
    if img2img:
        kw.update(init_latent=z0, t_enc=2)
    rt.sample_decode(3, None, hint, ctx_c, ctx_u, seeds=seeds, **kw)
    batch = rt.last_latents
    drawn = rt._loop_inputs(3, None, hint, ctx_c, ctx_u, 9.0, 1.0, eta, False, None,
                            None, kw.get("init_latent"), kw.get("t_enc"), None, 1,
                            0.0, None, None, None, seeds)[1][6:]
    assert len(drawn) == (eta > 0) + img2img
    for i, seed in enumerate(seeds):
        one = dict(kw, guidance_scale=kw["guidance_scale"][i],
                   strength=kw["strength"][i])
        if img2img:
            one["init_latent"] = z0[i:i + 1]
        rt.sample_decode(3, None, hint[i:i + 1], ctx_c[i:i + 1], ctx_u[i:i + 1],
                         seeds=[seed], **one)
        # the latents: rows of a batch share matrix products with other rows,
        # whose summation order the CPU library picks by size (2e-5 measured)
        assert (rt.last_latents[0] - batch[i]).abs().max().item() <= 1e-4
        # the random numbers: equal bytes
        alone = rt._loop_inputs(3, None, hint[i:i + 1], ctx_c[i:i + 1], ctx_u[i:i + 1],
                                9.0, 1.0, eta, False, None, None,
                                one.get("init_latent"), kw.get("t_enc"), None, 1, 0.0,
                                None, None, None, [seed])[1]
        if not img2img:
            assert torch.equal(alone[0][0], rt._loop_inputs(
                3, None, hint, ctx_c, ctx_u, 9.0, 1.0, eta, False, None, None, None,
                None, None, 1, 0.0, None, None, None, seeds)[1][0][i])
        for mine, theirs in zip(alone[6:], drawn):
            row = theirs[:, i] if theirs.dim() == 5 else theirs[i]
            assert torch.equal(mine.squeeze(-4), row)
    other = rt.sample(3, None, hint, ctx_c, ctx_u, seeds=[11, 12, 14], **kw)
    assert torch.equal(other[:2], batch[:2]) and not torch.equal(other[2], batch[2])


def test_draws_are_refused_without_a_source(rt):
    x_T, hint, ctx_c, ctx_u = _inputs()
    with pytest.raises(ValueError, match="generator= or seeds="):
        rt.sample(2, x_T, hint, ctx_c, ctx_u, eta=0.5)
    with pytest.raises(ValueError, match="seeds requires x_T=None"):
        rt.sample(2, x_T, hint, ctx_c, ctx_u, seeds=[1])
    with pytest.raises(ValueError, match="2 seeds for a batch of 1"):
        rt.sample(2, None, hint, ctx_c, ctx_u, seeds=[1, 2])


def test_report_has_one_line_an_engine(rt):
    x_T, hint, ctx_c, ctx_u = _inputs()
    assert rt.report() == ""
    rt.encode_prompt(np.zeros((2, CFG.clip.max_length), np.int64))
    rt.sample_decode(1, x_T, hint, ctx_c, ctx_u)
    rt.decode_latent(rt.sample(1, x_T, hint, ctx_c, ctx_u))
    lines = rt.report().splitlines()
    assert len(lines) == len(rt._engines) == 4
    assert sorted(line.split(":")[0] for line in lines) == [
        "clip_b2", "ddim+decode_1x1x64x64", "ddim_1x1x64x64", "decoder_b1_64x64"]
    assert all(line.endswith(": eager") for line in lines)  # no capture on the CPU


def test_warmup_self_test_and_release(runtimes):
    params_model = runtimes[1].model
    rt = port_engine.CNSDRuntime(params_model, PORT_CFG, device="cpu")
    assert rt.warmup(resolution=64, num_steps=2) == (1, 64, 64, 3)
    assert len(rt._engines) == 4 and not rt.capturing
    # a fused engine that disagrees with the granular path fails the warm-up
    key = next(k for k in rt._engines if k[0] == "sample_decode")
    fn = rt._engines[key]._fn
    rt._engines[key]._fn = lambda *a: tuple(255 - o if o.dtype == torch.uint8 else o
                                            for o in fn(*a))
    with pytest.raises(RuntimeError, match="differs from the granular path"):
        rt.warmup(resolution=64, num_steps=2)
    rt.release()
    assert rt._engines == {} and rt.model is None and rt.last_latents is None
    with pytest.raises(RuntimeError, match="released"):
        rt.sample_decode_engine(2, 1, 64, 64)
    with pytest.raises(ValueError, match="multiples of 64"):
        rt.warmup(resolution=100)


def test_graphs_need_a_cuda_device(runtimes):
    with pytest.raises(ValueError, match="CUDA device"):
        port_engine.CNSDRuntime(runtimes[1].model, PORT_CFG, device="cpu", graphs=True)


def test_eager_engine_runs_its_function():
    eng = port_engine.Engine(lambda a, b: (a + b, a * b), name="pair")
    assert eng.load(torch.ones(2), torch.ones(2)) is eng and not eng.compiled
    s, p = eng(torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]))
    assert s.tolist() == [4.0, 6.0] and p.tolist() == [3.0, 8.0]
    assert eng.infer(torch.ones(1), torch.ones(1))[0].item() == 2.0
    assert eng.compile_seconds is None


def test_eager_engine_sees_the_layout_of_a_capture():
    """An eager call gets contiguous arguments, as a captured engine's static
    buffers are, whatever the caller's strides."""
    eng = port_engine.Engine(lambda a: torch.tensor(a.is_contiguous()) + a.sum(), name="c")
    strided = torch.arange(24.0).reshape(2, 3, 4).permute(0, 2, 1)
    assert not strided.is_contiguous()
    assert eng(strided).item() == 1 + strided.sum().item()


def test_counters_can_be_taken_back_and_replayed():
    """What an engine does with the launch counters around a capture: the
    difference since a snapshot, taken back once, added at every replay."""
    plans = collections.Counter()
    dispatch.register_counter(plans)
    try:
        dispatch.reset_launches()
        dispatch.count_launch("fused_layer_norm")
        before = dispatch.counts()
        for _ in range(3):
            dispatch.count_launch("fused_attention_packed")
        dispatch.count_launch("fused_layer_norm")
        plans["a"] += 2
        delta = dispatch.counts_since(before)
        assert delta[0] == {"fused_attention_packed": 3, "fused_layer_norm": 1}
        assert delta[-1] == {"a": 2}
        dispatch.add_counts(delta, -1)
        assert dispatch.launches["fused_attention_packed"] == 0
        assert dispatch.launches["fused_layer_norm"] == 1 and plans["a"] == 0
        dispatch.add_counts(delta)
        dispatch.add_counts(delta)
        assert dispatch.launches["fused_attention_packed"] == 6
        assert dispatch.launches["fused_layer_norm"] == 3 and plans["a"] == 4
    finally:
        dispatch._COUNTERS.remove(plans)
        dispatch.reset_launches()


def test_constants_are_made_once_and_rounded_as_before():
    a = dispatch.const_tensor(0.18215, torch.bfloat16, torch.device("cpu"))
    assert a is dispatch.const_tensor(0.18215, torch.bfloat16, torch.device("cpu"))
    assert torch.equal(a, torch.tensor(0.18215, dtype=torch.bfloat16))
    from stablediffusioneo_tpu_torch.ops.schedule import _embedding_freqs

    assert _embedding_freqs(16, 10000, torch.device("cpu")) is \
        _embedding_freqs(16, 10000, torch.device("cpu"))
