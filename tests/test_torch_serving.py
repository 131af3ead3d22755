"""The PyTorch port's serving layer on the CPU at tiny size: the batch-cut
policy (its Python mirror against the JAX package's, its native library,
built into the port's own build directory, against its mirror), the
bit-packed hint (`_pack_hint` against the JAX package's, the packed engine
against the uint8 one), and DiffusionServer: batching, the grouping key
against the JAX server's, per-request parity with the port's process() (the
JAX test's contract: under 2% of pixels off by more than 1), two batches in
flight, errors, knob bounds, the prompt front end, img2img, inpainting and
the HTTP API."""

import base64
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.serving import scheduler as jax_sched
from stablediffusioneo_tpu_torch.serving import scheduler as port_sched
from stablediffusioneo_tpu_torch.utils import native

from torch_port_util import CFG, PORT_CFG

torch.set_num_threads(1)

STEPS, RES = 2, 64


def _img(seed, size=RES):
    rng = np.random.default_rng(seed)
    return (rng.random((size, size, 3)) * 255).astype(np.uint8)


def _canny_image(seed, size=RES):
    """A box with texture, so Canny finds edges."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 3), np.uint8)
    img[size // 4: 3 * size // 4, size // 5: 4 * size // 5] = 180
    return (img + rng.integers(0, 60, img.shape)).astype(np.uint8)


def _frac_off(a, b):
    return (np.abs(a.astype(np.int16) - b.astype(np.int16)) > 1).mean()


# ------------------------------------------------------------ policy core


def _random_cases(n=200, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(0, 9))
        ages = np.sort(rng.random(k) * 60.0)[::-1].copy()
        buckets = sorted(rng.choice([1, 2, 3, 4, 8], size=3, replace=False).tolist())
        mb = int(rng.choice([2, 4, 8]))
        w = float(rng.random() * 40.0)
        oldest = rng.random(int(rng.integers(1, 6))) * 50.0 - 10.0
        yield ages, buckets, mb, w, oldest


@pytest.mark.parametrize("impl", ["native", "mirror"])
def test_policy_cases(impl):
    """The JAX test's fixed cases, through the library and the mirror."""
    py = impl == "mirror"
    cut = port_sched.decide_cut
    assert cut([], (1, 2, 4), 4, 25.0, _force_python=py) == 0
    assert cut([5.0], (1, 2, 4), 4, 25.0, _force_python=py) == 0
    assert cut([26.0], (1, 2, 4), 4, 25.0, _force_python=py) == 1
    assert cut([1.0, 0.5, 0.2, 0.1], (1, 2, 4), 4, 25.0, _force_python=py) == 4
    assert cut([9, 8, 7, 6, 5, 4], (1, 2, 4), 4, 25.0, _force_python=py) == 4
    assert cut([10.0, 2.0, 1.0], (1, 2, 4), 4, 25.0, _force_python=py) == 0
    assert cut([30.0, 2.0, 1.0], (1, 2, 4), 4, 25.0, _force_python=py) == 2
    assert port_sched.pick_group([-1.0, 5.0, 12.0, -1.0], _force_python=py) == 2
    assert port_sched.pick_group([-1.0, -1.0], _force_python=py) == -1
    assert port_sched.next_deadline_ms([10.0], 25.0, _force_python=py) == pytest.approx(15.0)
    assert port_sched.next_deadline_ms([30.0], 25.0, _force_python=py) == 0.0
    assert port_sched.next_deadline_ms([], 25.0, _force_python=py) == -1.0


def test_mirror_matches_the_jax_mirror():
    for ages, buckets, mb, w, oldest in _random_cases():
        assert port_sched.decide_cut(ages, buckets, mb, w, _force_python=True) == \
            jax_sched.decide_cut(ages, buckets, mb, w, _force_python=True)
        assert port_sched.next_deadline_ms(ages, w, _force_python=True) == \
            jax_sched.next_deadline_ms(ages, w, _force_python=True)
        assert port_sched.pick_group(oldest, _force_python=True) == \
            jax_sched.pick_group(oldest, _force_python=True)


def test_native_library_matches_the_mirror():
    """The library, built by the port into its own build directory (never
    native/build/), equals the mirror over randomized inputs."""
    lib = port_sched._load()
    assert native.library_path("sdeo_sched").exists()
    assert native.library_path("sdeo_sched").parent == native.BUILD_DIR
    assert lib._name == str(native.library_path("sdeo_sched"))
    for ages, buckets, mb, w, oldest in _random_cases(seed=1):
        assert port_sched.decide_cut(ages, buckets, mb, w) == \
            port_sched.decide_cut(ages, buckets, mb, w, _force_python=True)
        assert port_sched.next_deadline_ms(ages, w) == pytest.approx(
            port_sched.next_deadline_ms(ages, w, _force_python=True))
        assert port_sched.pick_group(oldest) == \
            port_sched.pick_group(oldest, _force_python=True)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises; nothing falls back to the
    mirror, and nothing is written beside the sources."""
    (tmp_path / "scheduler.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cache", {})
    with pytest.raises(RuntimeError, match="building libsdeo_sched.so failed"):
        native.load_native_lib("sdeo_sched")
    assert not list((tmp_path / "build").glob("*.so"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["build", "scheduler.cpp"]


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    (tmp_path / "scheduler.cpp").write_text("int a;\n")
    monkeypatch.setattr(native, "NATIVE", tmp_path)
    first = native.library_path("sdeo_sched")
    (tmp_path / "scheduler.cpp").write_text("int b;\n")
    assert native.library_path("sdeo_sched") != first


# ------------------------------------------------------------ packed hint


@pytest.mark.parametrize("seed,low,high", [(0, 100, 200), (1, 50, 120), (2, 100, 200)])
def test_pack_hint_matches_jax(seed, low, high):
    from stablediffusioneo_tpu.annotators.canny import CannyDetector as JaxCanny
    from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipe
    from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector
    from stablediffusioneo_tpu_torch.annotators.util import HWC3
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    img = _canny_image(seed, size=96)
    raw = CannyDetector()(img, low, high)
    assert raw.tobytes() == JaxCanny()(img, low, high).tobytes() and raw.any()
    got = Canny2ImagePipeline._pack_hint(HWC3(raw), raw)
    want = JaxPipe._pack_hint(HWC3(raw), raw)
    assert got.dtype == np.uint8 and got.shape == (96, 12)
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(np.unpackbits(got, axis=-1) * 255, raw)
    # not binary, or a width that does not pack: the uint8 path (None) in both
    gray = img[..., 0]
    for m in (gray, raw[:, :90]):
        assert Canny2ImagePipeline._pack_hint(HWC3(m), m) is None
        assert JaxPipe._pack_hint(HWC3(m), m) is None


@pytest.fixture(scope="module")
def port_pipe():
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    model = ControlLDM(PORT_CFG)
    init_weights(model, torch.Generator().manual_seed(7))
    tok = toy_tokenizer(vocab_size=PORT_CFG.clip.vocab_size,
                        max_length=PORT_CFG.clip.max_length)
    return Canny2ImagePipeline(model, tok, PORT_CFG, device="cpu")


@pytest.mark.parametrize("guess_mode", [False, True])
def test_packed_engine_equals_uint8_engine(port_pipe, guess_mode):
    """The same Canny map as uint8 pixels and bit-packed: two engines, one
    image in bytes (and the latents equal)."""
    rt = port_pipe.runtime
    raw = port_pipe._annotate(_canny_image(3), 100, 200)[1]
    u8 = np.repeat(np.repeat(raw[None, ..., None], 3, axis=-1), 2, axis=0)
    packed = np.repeat(np.packbits(raw > 0, axis=-1)[None], 2, axis=0)
    ctx = rt.encode_prompt(np.zeros((4, PORT_CFG.clip.max_length), np.int64) + 5)
    x_T = torch.randn((2, RES // 8, RES // 8, 4), generator=torch.Generator().manual_seed(1))
    kw = dict(guidance_scale=[7.0, 9.0], strength=[1.0, 0.6], guess_mode=guess_mode)
    a = rt.sample_decode(STEPS, x_T, u8, ctx[:2], ctx[2:], **kw)
    za = rt.last_latents
    b = rt.sample_decode(STEPS, x_T, packed, ctx[:2], ctx[2:], **kw)
    assert torch.equal(a, b) and torch.equal(za, rt.last_latents)
    names = {e.name for e in rt._engines.values()}
    assert f"ddim+decode_{STEPS}x2x{RES}x{RES}" + ("_guess" if guess_mode else "") \
        + "_bithint" in names
    with pytest.raises(ValueError, match="packed"):
        rt.sample_decode(STEPS, x_T, packed.astype(np.float32), ctx[:2], ctx[2:])


def test_unpack_hint_is_numpys_unpackbits():
    from stablediffusioneo_tpu_torch.runtime.engine import unpack_hint

    bits = (np.random.default_rng(0).random((2, 16, 40)) > 0.5)
    packed = np.packbits(bits, axis=-1)
    out = unpack_hint(torch.from_numpy(packed), torch.bfloat16)
    assert out.shape == (2, 16, 40, 3) and out.dtype == torch.bfloat16
    assert out.is_contiguous()
    for c in range(3):
        assert np.array_equal(out[..., c].float().numpy(), bits.astype(np.float32))


def test_process_uploads_canny_packed(port_pipe):
    """process() runs a Canny request through the bit-packed engine, as the
    JAX package does, and a non-binary annotator's map through the uint8 one;
    the two images of a map that is binary are equal."""
    img = _canny_image(4)
    port_pipe.runtime._engines.clear()
    out = port_pipe.process(img, "a bird", image_resolution=RES, ddim_steps=STEPS, seed=5)
    assert [k[9] for k in port_pipe.runtime._engines if k[0] == "sample_decode"] == ["packed"]
    keep = port_pipe.apply_canny
    port_pipe.apply_canny = lambda im, lo, hi: keep(im, lo, hi)[..., None]  # (H, W, 1)
    try:
        again = port_pipe.process(img, "a bird", image_resolution=RES, ddim_steps=STEPS,
                                  seed=5)
    finally:
        port_pipe.apply_canny = keep
    assert [k[9] for k in port_pipe.runtime._engines if k[0] == "sample_decode"] == \
        ["packed", True]
    assert np.array_equal(out[0], again[0]) and np.array_equal(out[1], again[1])


# ----------------------------------------------------------------- server


@pytest.fixture(scope="module")
def tiny_server(port_pipe):
    from stablediffusioneo_tpu_torch.serving import DiffusionServer

    server = DiffusionServer(port_pipe, batch_buckets=(1, 2, 4), max_wait_ms=200.0)
    server.start()
    yield server, port_pipe
    server.stop(drain=False)


def _req(i, **kw):
    from stablediffusioneo_tpu_torch.serving import GenRequest

    kw = {"prompt": "a bird", "image_resolution": RES, "ddim_steps": STEPS,
          "seed": 100 + i, **kw}
    return GenRequest(image=_canny_image(i), **kw)


def _process(pipe, r, **extra):
    return pipe.process(
        r.image, r.prompt, a_prompt=r.a_prompt, n_prompt=r.n_prompt, num_samples=1,
        image_resolution=r.image_resolution, ddim_steps=r.ddim_steps, seed=r.seed,
        scale=r.scale, strength=r.strength, eta=r.eta, **extra)


def test_warmup_builds_every_bucket(tiny_server):
    server, pipe = tiny_server
    server.warmup(resolutions=(RES,), steps=STEPS)
    names = set(server.stats.snapshot()["engines"])
    for b in server.buckets:
        assert f"ddim+decode_{STEPS}x{b}x{RES}x{RES}_bithint" in names
        assert f"clip_b{2 * b}" in names


def test_concurrent_requests_batch_and_match_process(tiny_server):
    server, pipe = tiny_server
    server.drain(timeout=120)
    server.stats.reset()
    reqs = [_req(10, scale=9.0, strength=1.0), _req(11, prompt="a dog", scale=5.0,
                                                     strength=0.7),
            _req(12, prompt="a cat", scale=13.0, strength=1.4)]
    results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
    st = server.stats.snapshot()
    assert st["requests"] == 3 and st["batches"] < 3, st
    assert sum(b * n for b, n in st["batch_hist"].items()) == 3
    for r, (det, im) in zip(reqs, results):
        outs = _process(pipe, r)
        assert np.array_equal(det, outs[0])
        assert im.shape == (RES, RES, 3) and im.dtype == np.uint8
        assert _frac_off(im, outs[1]) < 0.02


def test_row_bytes_do_not_depend_on_batch_mates(tiny_server):
    """Within one bucket a row's bytes depend on its own request only: the
    same request batched with two different companions."""
    server, _ = tiny_server
    server.drain(timeout=120)
    target = _req(20, scale=7.0)
    images = []
    for mate in (21, 22):
        futures = [server.submit(r) for r in (target, _req(mate, prompt="a fox",
                                                           scale=11.0))]
        images.append(futures[0].result(timeout=120)[1])
        futures[1].result(timeout=120)
    assert server.stats.batch_hist.get(2, 0) >= 2
    assert np.array_equal(images[0], images[1])


def test_two_batches_in_flight_each_get_their_own_images(tiny_server, monkeypatch):
    """Batch N+1 is enqueued before batch N is fetched (the completion
    thread is held); every request still gets the image of its own row."""
    server, pipe = tiny_server
    server.drain(timeout=120)
    release, both = threading.Event(), threading.Event()
    fetch = server._fetch

    def held(images_dev, ready):
        if not release.is_set():
            both.wait(timeout=60)  # until the second batch is dispatched
            release.set()
        return fetch(images_dev, ready)

    dispatch = server._dispatch_batch

    def counted(batch):
        dispatch(batch)
        if server._fetching >= 2:
            both.set()

    monkeypatch.setattr(server, "_fetch", held)
    monkeypatch.setattr(server, "_dispatch_batch", counted)
    reqs = [_req(30 + i, scale=6.0 + i) for i in range(8)]
    results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
    assert both.is_set(), "the second batch was not dispatched before the first fetch"
    for r, (_, im) in zip(reqs[:2] + reqs[-2:], results[:2] + results[-2:]):
        assert _frac_off(im, _process(pipe, r)[1]) < 0.02


def test_a_capture_waits_until_no_batch_is_fetched(tiny_server):
    """The runtime's capture guard is the server's: entered while a batch is
    being fetched, it returns only once that fetch is done."""
    server, pipe = tiny_server
    assert pipe.runtime.capture_guard == server._capture_window
    entered = threading.Event()

    def capture():
        with server._capture_window():
            entered.set()

    with server._wake:
        server._fetching += 1
    worker = threading.Thread(target=capture)
    worker.start()
    try:
        assert not entered.wait(0.3)
    finally:
        with server._wake:
            server._fetching -= 1
            server._wake.notify_all()
    assert entered.wait(10)
    worker.join(10)
    assert not worker.is_alive()


def test_incompatible_requests_do_not_batch(tiny_server):
    server, _ = tiny_server
    server.drain(timeout=120)
    b0 = server.stats.batches
    futures = [server.submit(_req(40)), server.submit(_req(41, ddim_steps=3))]
    for f in futures:
        assert f.result(timeout=120)[1].dtype == np.uint8
    assert server.stats.batches - b0 == 2


# requests of every kind the grouping key tells apart
def _key_requests():
    mask = np.zeros((RES, RES), np.uint8)
    mask[:, 32:] = 255
    long_text = " ".join(f"word{i}" for i in range(40))
    return [
        {}, {"ddim_steps": 3}, {"guess_mode": True}, {"eta": 0.5}, {"sampler": "euler-a"},
        {"encoder_cache_interval": 2}, {"clip_skip": 2}, {"image_resolution": 128},
        {"long_prompt": "auto"}, {"long_prompt": "auto", "prompt": long_text},
        {"long_prompt": True}, {"prompt_emphasis": True, "prompt": "a (red:1.5) bird"},
        {"inpaint_image": _img(1), "inpaint_mask": mask},
        {"init_image": _img(2), "denoise_strength": 0.5},
        {"cfg_rescale": 0.69}, {"tome_ratio": 0.5},
    ]


def test_grouping_keys_equal_the_jax_servers(port_pipe):
    """The same requests give the JAX server's keys (its pre-processing run
    on a pipeline without a runtime: only the keys are read)."""
    from stablediffusioneo_tpu.annotators.canny import CannyDetector as JaxCanny
    from stablediffusioneo_tpu.models.tokenizer import toy_tokenizer as jax_toy
    from stablediffusioneo_tpu.pipeline.canny2image import Canny2ImagePipeline as JaxPipe
    from stablediffusioneo_tpu.serving import DiffusionServer as JaxServer
    from stablediffusioneo_tpu.serving import GenRequest as JaxRequest
    from stablediffusioneo_tpu_torch.serving import DiffusionServer, GenRequest

    jax_pipe = object.__new__(JaxPipe)
    jax_pipe.apply_canny, jax_pipe.annotators = JaxCanny(), None
    jax_pipe.tokenizer = jax_toy(vocab_size=CFG.clip.vocab_size,
                                 max_length=CFG.clip.max_length)
    jax_pipe.cfg = CFG
    guard = port_pipe.runtime.capture_guard
    servers = [JaxServer(jax_pipe), DiffusionServer(port_pipe)]
    for server in servers:
        server._thread = threading.current_thread()  # submit() without a dispatcher
    try:
        for i, kw in enumerate(_key_requests()):
            kw = {"prompt": "a bird", "image_resolution": RES, "seed": i, **kw}
            image = _canny_image(i, kw["image_resolution"])
            servers[0].submit(JaxRequest(image=image, **kw))
            servers[1].submit(GenRequest(image=image, **kw))
        keys = [list(s._groups) for s in servers]
        # a short "auto" prompt and emphasis batch with plain requests, and
        # this long prompt needs 3 windows, as long_prompt=True
        assert keys[1] == keys[0] and len(keys[0]) == len(_key_requests()) - 3
        for jq, pq in zip(*(s._groups.values() for s in servers)):
            assert [p.req.seed for p in jq] == [p.req.seed for p in pq]
            for jp, pp in zip(jq, pq):
                assert np.array_equal(np.asarray(jp.hint), pp.hint)
                assert np.array_equal(jp.ids, pp.ids)
                assert np.array_equal(jp.detected_map, pp.detected_map)
    finally:
        servers[1]._thread = None
        port_pipe.runtime.capture_guard = guard


def test_drain_covers_inflight_batches_and_stats_reset(tiny_server):
    server, _ = tiny_server
    futures = [server.submit(_req(50 + i)) for i in range(5)]
    server.drain(timeout=120)
    assert all(f.done() for f in futures)
    st = server.stats.snapshot()
    assert st["requests"] >= 5
    assert st["mean_queue_ms"] > 0 and st["spans"]["serving.dispatch"]["mean_ms"] > 0
    assert sum(st["cuts"].values()) == st["batches"]
    engines = st["engines"]
    server.stats.reset()
    st = server.stats.snapshot()
    assert st["requests"] == 0 and st["batches"] == 0 and st["batch_hist"] == {}
    assert st["spans"] == {} and st["cuts"] == {"full": 0, "window": 0}
    assert st["at_depth_s"] == 0
    assert st["engines"] == engines  # the device's engines are not traffic
    assert st["capture_s"] == 0 and st["pool_bytes"] == 0  # the CPU captures nothing


def test_error_stays_with_its_request(tiny_server):
    server, _ = tiny_server
    server.drain(timeout=120)
    e0 = server.stats.errors
    bad = server.submit(_req(60, sampler="no-such-sampler"))
    ok = server.submit(_req(61))
    with pytest.raises(ValueError, match="unknown sampler"):
        bad.result(timeout=120)
    assert ok.result(timeout=120)[1].dtype == np.uint8
    assert server.stats.errors == e0 + 1


def test_engine_minting_knobs_bounded(tiny_server):
    server, _ = tiny_server
    for kw, match in (({"ddim_steps": server.max_steps + 1}, "ddim_steps"),
                      ({"ddim_steps": 0}, "ddim_steps"),
                      ({"image_resolution": server.max_resolution + 64}, "image_resolution"),
                      ({"image_resolution": 32}, "image_resolution"),
                      ({"encoder_cache_interval": 3}, "encoder_cache_interval"),
                      ({"cfg_rescale": 1.5}, "cfg_rescale"),
                      ({"tome_ratio": 0.9}, "tome_ratio"),
                      ({"strength": (1.0, 0.5)}, "strengths"),
                      ({"prompt_emphasis": True, "long_prompt": True}, "long_prompt"),
                      ({"inpaint_image": _img(0)}, "inpaint_mask")):
        with pytest.raises(ValueError, match=match):
            server.submit(_req(70, **kw))


def test_continuous_knobs_snap_to_the_grid(tiny_server):
    """0.69 and 0.71 both snap to 0.7 and batch together; the caller's
    requests are not changed."""
    server, _ = tiny_server
    server.drain(timeout=120)
    b0 = server.stats.batches
    reqs = [_req(80 + i, cfg_rescale=v) for i, v in enumerate((0.69, 0.71))]
    for f in [server.submit(r) for r in reqs]:
        f.result(timeout=120)
    assert server.stats.batches - b0 == 1
    assert [r.cfg_rescale for r in reqs] == [0.69, 0.71]


def test_long_prompt_groups_apart_and_matches_process(tiny_server):
    server, pipe = tiny_server
    server.drain(timeout=120)
    long_text = " ".join(f"word{i}" for i in range(40))
    b0 = server.stats.batches
    reqs = [_req(90, prompt=long_text, long_prompt="auto"), _req(91, prompt="a dog")]
    results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
    assert server.stats.batches - b0 == 2, "context lengths must not batch"
    outs = _process(pipe, reqs[0], long_prompt="auto")
    assert _frac_off(results[0][1], outs[1]) < 0.02
    # a short prompt with "auto" is one window: it batches with plain requests
    b0 = server.stats.batches
    texts = {"a_prompt": "", "n_prompt": "bad"}
    short = [_req(92, long_prompt="auto", **texts), _req(93, prompt="a dog", **texts)]
    for f in [server.submit(r) for r in short]:
        f.result(timeout=120)
    assert server.stats.batches - b0 == 1


def test_emphasis_batches_with_plain_and_matches_process(tiny_server):
    server, pipe = tiny_server
    server.drain(timeout=120)
    b0 = server.stats.batches
    reqs = [_req(94, prompt="a (red:1.8) bird", prompt_emphasis=True),
            _req(95, prompt="a dog")]
    results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
    assert server.stats.batches - b0 == 1
    for r, (_, im) in zip(reqs, results):
        outs = _process(pipe, r, prompt_emphasis=r.prompt_emphasis)
        assert _frac_off(im, outs[1]) < 0.02


@pytest.mark.parametrize("kind", ["inpaint", "img2img"])
def test_encoder_requests_batch_and_match_process(tiny_server, kind):
    server, pipe = tiny_server
    server.drain(timeout=120)
    src = _img(100)
    mask = np.zeros((RES, RES), np.uint8)
    mask[:, 32:] = 255
    extra = ({"inpaint_image": src, "inpaint_mask": mask} if kind == "inpaint"
             else {"init_image": src, "denoise_strength": 0.5})
    b0 = server.stats.batches
    reqs = [_req(101, **extra), _req(102, prompt="a dog", **extra), _req(103)]
    results = [f.result(timeout=120) for f in [server.submit(r) for r in reqs]]
    assert server.stats.batches - b0 == 2  # the plain request is its own group
    for r, (det, im) in zip(reqs[:2], results[:2]):
        outs = _process(pipe, r, **extra)
        assert np.array_equal(det, outs[0])
        assert _frac_off(im, outs[1]) < 0.02


def test_submit_async_matches_submit(tiny_server):
    server, _ = tiny_server
    server.drain(timeout=120)
    async_outs = [f.result(timeout=120) for f in [server.submit_async(_req(110 + i))
                                                  for i in range(3)]]
    sync_outs = [f.result(timeout=120) for f in [server.submit(_req(110 + i))
                                                 for i in range(3)]]
    for (da, ia), (ds, is_) in zip(async_outs, sync_outs):
        assert np.array_equal(da, ds)
        assert _frac_off(ia, is_) < 0.02
    bad = server.submit_async(_req(120, cfg_rescale=5.0))
    with pytest.raises(ValueError, match="cfg_rescale"):
        bad.result(timeout=60)


def _png_b64(arr):
    import cv2

    ok, buf = cv2.imencode(".png", cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _decode_png(b64):
    import cv2

    img = cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def test_http_api(tiny_server):
    """POST /generate (concurrent clients batch; inpaint and img2img by
    their _b64 fields), GET /stats and /healthz; 400 for a bad body, 404
    for another route."""
    from stablediffusioneo_tpu_torch.serving import make_http_server

    server, pipe = tiny_server
    server.drain(timeout=120)
    httpd = make_http_server(server, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        common = {"prompt": "a bird", "image_resolution": RES, "ddim_steps": STEPS}
        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(lambda s: post({"image_b64": _png_b64(_canny_image(s)),
                                                 "seed": s, **common}), [130, 131]))
        for s, payload in zip((130, 131), outs):
            img = _decode_png(payload["image_b64"])
            assert img.shape == (RES, RES, 3) and img.dtype == np.uint8
            ref = pipe.process(_canny_image(s), "a bird", image_resolution=RES,
                               ddim_steps=STEPS, seed=s)
            assert np.array_equal(_decode_png(payload["detected_b64"]), ref[0])
            assert _frac_off(img, ref[1]) < 0.02
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            st = json.loads(r.read())
        assert st["requests"] >= 2 and "engines" in st
        mask = np.zeros((RES, RES), np.uint8)
        mask[:, 32:] = 255
        src = _png_b64(_img(132))
        out = post({"image_b64": src, "inpaint_image_b64": src,
                    "inpaint_mask_b64": _png_b64(np.repeat(mask[..., None], 3, -1)),
                    "seed": 7, **common})
        assert _decode_png(out["image_b64"]).shape == (RES, RES, 3)
        out = post({"image_b64": src, "init_image_b64": src, "denoise_strength": 0.5,
                    "seed": 7, **common})
        assert "image_b64" in out
        for body in (b'{"prompt": "no image"}',
                     json.dumps({"image_b64": base64.b64encode(b"no png").decode(),
                                 "prompt": "x"}).encode(),
                     json.dumps({"image_b64": src, "init_image": [[0]],
                                 "prompt": "x"}).encode(),
                     json.dumps({"image_b64": src, "prompt": "x",
                                 "cfg_rescale": 3.0}).encode()):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(base + "/generate",
                                                              data=body), timeout=30)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
