"""DiffusionServer: cross-request batching over captured engines
(counterpart of stablediffusioneo_tpu/serving/server.py, same names, knob
bounds and grouping key).

  submit(GenRequest) -> Future          (any thread)
       | host work on the caller thread: annotate, bit-pack, tokenize
       v
  per-compatibility-group queues        (resolution, steps, sampler,
       |                                 guess mode, context length, hint
       v                                 variant, ...: one engine each)
  dispatcher thread: the batch-cut policy (serving/scheduler.py over
       |             native/scheduler.cpp) decides when to cut and how big
       v
  ONE batched CLIP call + ONE batched sample_decode engine call, per-request
  prompts, seeds, guidance scales and control strengths riding the batch
       |             (the engine's static output is copied on the
       v              dispatcher's stream and an event recorded after it)
  completion thread: waits for the event, fetches to the host, resolves the
  futures with (detected_map, image)

Each request's life is recorded as spans (runtime/profiling.py), all carrying
its request id: `serving.prep` (submit's host work), `serving.queue` (in its
group until the cut), the batch's `serving.dispatch` (dispatch start -> device
work enqueued; its device time runs from an event at dispatch start to the
`ready` event), `serving.behind` (dispatch start -> the batch's device start:
the host time the completion thread saw `ready`, less the batch's device time),
`serving.fetch` (`ready` seen -> futures resolved), and the root
`serving.request` (submit -> futures resolved). `ServerStats` tallies them.

While the card runs one batch the queues keep filling (continuous batching),
and with max_inflight_batches=2 the next batch is enqueued before the last
one is fetched. Each row's x_T and step noise are drawn from its own seed's
generator outside the graph (`sample_decode(seeds=)`), so a request's bytes do
not depend on the other rows' requests. On the card they do depend on the
bucket (cuDNN picks convolution algorithms by batch size) and on the row's
place in the batch: a batch-4 row and the same request through process() at
batch 1 differ in the last bits, which 20 steps of untrained nets spread over
~10% of the pixels (scripts/torch_batch_variance.py).

Threads and the card. Only the dispatcher thread runs device work and
launches kernels (the launch counters of ops/dispatch.py are plain Python);
it runs under torch.no_grad() on a stream of its own. The completion thread
only waits for an event and copies to the host. A CUDA graph capture in
torch's default (global) mode fails when another thread makes such a call
meanwhile, so every capture waits until no batch is being fetched
(`CNSDRuntime.capture_guard`) and `warmup()` holds the dispatcher off while it
captures: warm every (bucket, resolution) before traffic, and a request that
still needs a new engine is captured only when nothing is in flight. The
pipeline's runtime must not be used from another thread while the server
runs.

Over a mesh runtime (a pipeline built with mesh=, parallel/mesh.py) every
rank builds the same pipeline and server; rank 0 calls start() and owns
the queues, the batch-cut policy and the futures, and the other ranks call
follow(): at each cut (and warm-up) rank 0 broadcasts the cut's requests,
so that every rank makes the same engine calls. A bucket that does not tile
dp runs whole on every rank, not as a failure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from stablediffusioneo_tpu_torch.runtime import profiling
from stablediffusioneo_tpu_torch.serving.scheduler import (
    decide_cut,
    next_deadline_ms,
    pick_group,
)


def _resolve(fut: Future, result=None, exc=None) -> bool:
    """Resolve a request future, tolerating a concurrent cancel().

    An HTTP-timeout `cancel()` can land between a `done()` check and the
    set — set_result/set_exception then raise InvalidStateError, and (when
    raised inside the batch completion loop) would spuriously fail every
    co-batched request. Cancellation simply wins instead."""
    try:
        if fut.done():
            return False
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


@dataclass
class GenRequest:
    """One generation request: the per-call knobs of `process()`
    (canny2image_TRT.py:51), one image a request. strength: a number, or
    with a multi-ControlNet pipeline a tuple of one a net."""

    image: np.ndarray
    prompt: str
    a_prompt: str = "best quality, extremely detailed"
    n_prompt: str = ("longbody, lowres, bad anatomy, bad hands, "
                     "missing fingers, extra digit, fewer digits, cropped, "
                     "worst quality, low quality")
    image_resolution: int = 256
    ddim_steps: int = 20
    guess_mode: bool = False
    strength: Union[float, Tuple[float, ...]] = 1.0
    scale: float = 9.0
    seed: int = -1
    eta: float = 0.0
    low_threshold: int = 100
    high_threshold: int = 200
    sampler: str = "ddim"
    encoder_cache_interval: int = 1
    clip_skip: int = 0
    # blended-latent inpainting: source image + mask (nonzero = regenerate),
    # encoded with the posterior mode
    inpaint_image: Optional[np.ndarray] = None
    inpaint_mask: Optional[np.ndarray] = None
    # img2img: requests batch only with the same entry step t_enc
    init_image: Optional[np.ndarray] = None
    denoise_strength: float = 0.75
    prompt_emphasis: bool = False
    # False: truncate at 77; True: 3 x 77 windows; "auto": the fewest windows
    long_prompt: Union[bool, str] = False
    # static per engine: requests batch per value (0.05 grid)
    cfg_rescale: float = 0.0
    tome_ratio: float = 0.0


@dataclass
class _Pending:
    req: GenRequest
    future: Future
    t_submit: float
    detected_map: np.ndarray = None
    hint: Any = None                   # (H, W, 3) uint8, (H, W//8) bit-packed,
                                       # or a tuple of (H, W, 3) f32, one a net
    ids: np.ndarray = None             # (2, 77) or (2, F, 77) token ids
    hw: Tuple[int, int] = (0, 0)
    seed: int = 0                      # resolved per submission (-1 drawn)
    inpaint_src: np.ndarray = None     # (H, W, 3) f32 in [-1, 1]
    inpaint_mask: np.ndarray = None    # (h, w, 1) f32 latent-res, 1 = generate
    init_src: np.ndarray = None        # (H, W, 3) f32 in [-1, 1] (img2img)
    t_enc: int = 0                     # img2img entry step (0 = off)
    weights: np.ndarray = None         # (2, 77) emphasis weights (or None)
    rid: int = 0                       # request id: on every span of the request,
                                       # and its `serving.request` span's own id
    prep: Any = None                   # its `serving.prep` span
    t_enq: float = 0.0                 # appended to its group
    t_cut: float = 0.0                 # cut into a batch


def _no_cuts() -> Dict[str, int]:
    # `full`: the largest bucket filled; `window`: the oldest request's
    # batching window ran out (serving/scheduler.py:decide_cut)
    return {"full": 0, "window": 0}


@dataclass
class ServerStats:
    """The traffic since the last reset(). queue_ms_sum: each row's submit ->
    its batch's dispatch start. cuts: batches cut by reason. at_depth_s: the
    dispatcher's time waiting with max_inflight_batches in flight.
    span_sums: for each span name of the fetched batches (`add_spans`), the
    count, host ms, count with a device time and device ms."""

    requests: int = 0
    batches: int = 0
    rows: int = 0
    errors: int = 0
    queue_ms_sum: float = 0.0
    batch_hist: Dict[int, int] = field(default_factory=dict)
    cuts: Dict[str, int] = field(default_factory=_no_cuts)
    at_depth_s: float = 0.0
    span_sums: Dict[str, List[float]] = field(default_factory=dict)
    # the runtime's engines ({name: get_engine_infor()}): capture seconds and
    # graph pool bytes. Not cleared by reset(): it is device state, not traffic.
    engines: Dict[str, Dict] = field(default_factory=dict)

    def add_spans(self, spans) -> None:
        for sp in spans:
            acc = self.span_sums.setdefault(sp.name, [0, 0.0, 0, 0.0])
            acc[0] += 1
            acc[1] += sp.ms
            if sp.device_ms is not None:
                acc[2] += 1
                acc[3] += sp.device_ms

    def snapshot(self) -> Dict:
        b = max(self.batches, 1)
        captured = [e for e in self.engines.values() if e.get("compiled")]
        return {
            "requests": self.requests,
            "batches": self.batches,
            "rows": self.rows,
            "mean_batch": self.rows / b,
            "mean_queue_ms": self.queue_ms_sum / max(self.rows, 1),
            "errors": self.errors,
            "batch_hist": dict(self.batch_hist),
            "cuts": dict(self.cuts),
            "at_depth_s": self.at_depth_s,
            # each span name: its count, mean host ms and mean device ms
            "spans": {name: {"count": n, "mean_ms": host / n, "device_count": nd,
                             "mean_device_ms": dev / nd if nd else None}
                      for name, (n, host, nd, dev) in self.span_sums.items()},
            "engines": {name: dict(info) for name, info in self.engines.items()},
            "capture_s": sum(e["compile_seconds"] for e in captured),
            "pool_bytes": sum(e["memory"]["pool_bytes"] for e in captured),
        }

    def reset(self):
        self.requests = self.batches = self.rows = self.errors = 0
        self.queue_ms_sum = self.at_depth_s = 0.0
        self.batch_hist, self.cuts, self.span_sums = {}, _no_cuts(), {}


class DiffusionServer:
    """Batched serving front end over a Canny2ImagePipeline.

    batch_buckets: the engine batch sizes to capture and serve (each one
    engine). max_wait_ms: the batching window, the extra latency a lone
    request may pay waiting for company. max_steps / max_resolution bound
    the knobs that mint engines (every distinct value is a new capture)."""

    def __init__(
        self,
        pipeline,
        batch_buckets: Tuple[int, ...] = (1, 2, 4),
        max_wait_ms: float = 25.0,
        max_inflight_batches: int = 2,
        preprocess_workers: int = 4,
        max_steps: int = 200,
        max_resolution: int = 1024,
    ):
        self.pipe = pipeline
        self.max_steps = int(max_steps)
        self.max_resolution = int(max_resolution)
        self.buckets = tuple(sorted(batch_buckets))
        if self.buckets[0] != 1:
            # without a batch-1 engine a lone request could never dispatch
            raise ValueError("batch_buckets must include 1")
        self.max_batch = self.buckets[-1]
        self.max_wait_ms = float(max_wait_ms)
        # 1: cut only when the card is idle; 2: keep one batch queued behind
        # the running one, while the queue still grows into full buckets
        self.max_inflight_batches = int(max_inflight_batches)
        self._groups: Dict[Tuple, List[_Pending]] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._done_q: "queue.Queue" = queue.Queue()
        self._inflight: List[Future] = []
        self._inflight_batches = 0
        self._fetching = 0  # batches handed to the completion thread, not done
        # held by the dispatcher around a batch's device work and by warmup()
        self._device_lock = threading.Lock()
        self._pre_pool = None
        self._preprocess_workers = int(preprocess_workers)
        self.stats = ServerStats()
        pipeline.runtime.capture_guard = self._capture_window

    # ---------------------------------------------------------------- control

    def start(self) -> "DiffusionServer":
        if self._thread is not None:
            return self
        if not self._lead():
            raise RuntimeError("on a mesh runtime only rank 0 serves; the other "
                               "ranks call follow()")
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="sdeo-dispatch", daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="sdeo-complete", daemon=True)
        self._thread.start()
        self._completer.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the dispatcher. drain=True serves queued requests first. On
        a mesh runtime the other ranks' `follow` returns."""
        if self._thread is None:
            return
        if drain:
            self.drain()
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        self._thread.join()
        self._thread = None
        self._publish(None)
        self._done_q.put(None)  # the completer drains in-flight batches first
        self._completer.join()
        self._completer = None
        if self._pre_pool is not None:
            self._pre_pool.shutdown(wait=True)
            self._pre_pool = None

    def drain(self, timeout: float = 300.0):
        """Block until every queued request has been dispatched and resolved."""
        from concurrent.futures import wait as futures_wait

        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                futures = [p.future for q in self._groups.values() for p in q]
                futures += [f for f in self._inflight if not f.done()]
            if not futures:
                return
            # wait without re-raising: a failed request's exception belongs
            # to its submitter
            futures_wait(futures, timeout=max(0.0, deadline - time.perf_counter()))
        raise TimeoutError("serving queue did not drain")

    def warmup(self, resolutions=(256,), steps=20, sampler="ddim"):
        """Build (on the card: capture) the sample_decode engine and the
        CLIP engine of every (batch bucket, resolution) before traffic, with
        the hint variant requests will take: one float hint a net for a
        multi-ControlNet pipeline, bit-packed for Canny, else uint8. On a
        capturing runtime an engine that is not a captured graph fails the
        warm-up. The census goes to `stats.engines`."""
        from stablediffusioneo_tpu_torch.annotators.canny import CannyDetector

        rt = self.pipe.runtime
        if self.pipe.annotators is not None:
            hint_mode = "multi"
        elif isinstance(self.pipe.apply_canny, CannyDetector):
            hint_mode = "packed"  # canny maps are binary: requests arrive packed
        else:
            hint_mode = True
        self._publish(("warmup", (tuple(resolutions), steps, sampler)))
        with self._device_lock:
            engines = []
            for res in resolutions:
                for b in self.buckets:
                    engines.append(rt.sample_decode_engine(
                        steps, b, res, res, sampler=sampler, hint_u8=hint_mode))
                    engines.append(rt.clip_engine(2 * b))
        if rt.capturing:
            eager = [e.name for e in engines if not e.compiled]
            if eager:
                raise RuntimeError(f"serving warmup: engines were not captured: {eager}")
        with self._lock:
            self.stats.engines = rt.engine_census()
        return self

    # ------------------------------------------------------------- mesh

    def _lead(self) -> bool:
        mesh = self.pipe.runtime.mesh
        return mesh is None or mesh.rank == mesh.ranks[0]

    def _publish(self, msg) -> None:
        """Rank 0 of a mesh runtime: hand `msg` (a warm-up, a cut, or None
        to stop) to the other ranks' `follow`, so that every rank makes the
        same engine calls. No-op without a mesh."""
        mesh = self.pipe.runtime.mesh
        if mesh is not None and self._lead():
            from stablediffusioneo_tpu_torch.parallel.mesh import broadcast_object

            broadcast_object(msg, mesh)

    def follow(self) -> int:
        """The loop of a rank other than 0 of a mesh runtime (the JAX server
        over a mesh runtime is one controller; the port's is one process a
        rank): rank 0 owns the queue, the batch-cut policy and the futures;
        at each cut it broadcasts the cut's requests (ids, hints, seeds,
        sizes), and this rank runs the same warm-ups and engine calls, until
        rank 0's `stop()`. Returns the number of cuts run."""
        mesh = self.pipe.runtime.mesh
        if mesh is None or self._lead():
            raise RuntimeError("follow() runs on the other ranks of a mesh runtime; "
                               "rank 0 calls start()")
        from stablediffusioneo_tpu_torch.parallel.mesh import broadcast_object

        cuts = 0
        with torch.no_grad():
            while True:
                msg = broadcast_object(None, mesh)
                if msg is None:
                    return cuts
                kind, payload = msg
                if kind == "warmup":
                    self.warmup(*payload)
                else:
                    self._run_call(payload).cpu()
                    cuts += 1

    @contextlib.contextmanager
    def _capture_window(self):
        """Entered around every capture of the runtime: wait until no batch
        is being fetched. The dispatcher (or warmup) is the one capturing and
        the only source of fetches, so none starts until the capture ends."""
        with self._wake:
            while self._fetching:
                self._wake.wait()
        yield

    # ---------------------------------------------------------------- submit

    def submit(self, req: GenRequest) -> Future:
        """Enqueue a request; host work (annotate, bit-pack, tokenize) runs on
        the caller thread, so the dispatcher only does device work. The
        Future resolves to (detected_map, image), both uint8 HWC."""
        if self._thread is None:
            raise RuntimeError("server not started — call start()")
        # ddim_steps, image_resolution, cfg_rescale and tome_ratio are in the
        # engine key: bound them, and snap the two continuous ones to a 0.05
        # grid, so that a client sweeping values cannot mint unbounded captures
        if not (1 <= req.ddim_steps <= self.max_steps):
            raise ValueError(
                f"ddim_steps must be in [1, {self.max_steps}] (every "
                f"distinct value captures a new engine; raise "
                f"DiffusionServer(max_steps=...) to widen), got "
                f"{req.ddim_steps}")
        if not (64 <= req.image_resolution <= self.max_resolution):
            raise ValueError(
                f"image_resolution must be in [64, {self.max_resolution}] "
                f"(engines are captured per /64 value; raise "
                f"DiffusionServer(max_resolution=...) to widen), got "
                f"{req.image_resolution}")
        if not (1 <= req.encoder_cache_interval <= req.ddim_steps):
            raise ValueError(
                f"encoder_cache_interval must be in [1, ddim_steps], got "
                f"{req.encoder_cache_interval}")
        if not (0.0 <= req.cfg_rescale <= 1.0):
            raise ValueError(
                f"cfg_rescale must be in [0, 1], got {req.cfg_rescale}")
        if not (0.0 <= req.tome_ratio <= 0.75):
            raise ValueError(
                f"tome_ratio must be in [0, 0.75], got {req.tome_ratio}")
        if isinstance(req.strength, (tuple, list)):
            n = len(self.pipe.annotators or ())
            if len(req.strength) != n:
                raise ValueError(f"{len(req.strength)} strengths for a pipeline of "
                                 f"{n or 'one'} ControlNet(s) taking per-net strengths")
        quant = {}
        for name in ("cfg_rescale", "tome_ratio"):
            v = getattr(req, name)
            q = round(v * 20.0) / 20.0
            if q != v:
                quant[name] = q
        if quant:
            req = dataclasses.replace(req, **quant)  # the caller's req untouched

        p = _Pending(req=req, future=Future(), t_submit=time.perf_counter(),
                     rid=profiling.new_id())
        with profiling.span("serving.prep", requests=(p.rid,), parent=p.rid) as p.prep:
            self._prepare(p)
        with self._wake:
            p.t_enq = time.perf_counter()
            self._groups.setdefault(self._key(p), []).append(p)
            self.stats.requests += 1
            self._wake.notify_all()
        return p.future

    def _prepare(self, p: _Pending) -> None:
        """submit()'s host work on the caller thread: resize, annotate,
        bit-pack, tokenize, resolve the seed, prepare the img2img and
        inpainting sources."""
        from stablediffusioneo_tpu_torch.annotators.util import HWC3, resize_image

        req = p.req
        img = resize_image(HWC3(req.image), req.image_resolution)
        p.hw = img.shape[:2]
        maps, hint = self.pipe._hint(img, req.low_threshold, req.high_threshold, 1)
        p.detected_map = maps[0]
        p.hint = tuple(h[0] for h in hint) if isinstance(hint, tuple) else hint[0]
        cond_text = (req.prompt + ", " + req.a_prompt
                     if req.a_prompt else req.prompt)
        tok = self.pipe.tokenizer
        if req.prompt_emphasis:
            from stablediffusioneo_tpu_torch.models.text_encoding import tokenize_weighted

            if req.long_prompt:
                raise ValueError("prompt_emphasis + long_prompt is "
                                 "unsupported (pick one encoder path)")
            p.ids, p.weights = tokenize_weighted(tok, [cond_text, req.n_prompt])
        elif req.long_prompt:
            from stablediffusioneo_tpu_torch.models.text_encoding import (
                needed_windows,
                tokenize_windowed,
            )

            f = (needed_windows(tok, [cond_text, req.n_prompt])
                 if req.long_prompt == "auto" else 3)
            p.ids = tokenize_windowed(tok, [cond_text, req.n_prompt], windows=f)
            if f == 1:
                # a 1-window grid is the truncated grid: rank 2, so that it
                # batches with plain requests
                p.ids = p.ids[:, 0]
        else:
            p.ids = np.asarray(tok([cond_text, req.n_prompt]))
        # seed=-1 drawn per submission, the caller's request untouched
        p.seed = (int(np.random.randint(0, 2 ** 31 - 1))
                  if req.seed == -1 else int(req.seed))
        H, W = p.hw
        if req.inpaint_image is not None:
            if req.inpaint_mask is None:
                raise ValueError("inpaint_image requires inpaint_mask")
            from stablediffusioneo_tpu_torch.pipeline.inpaint import prepare_inpaint

            p.inpaint_src, p.inpaint_mask = prepare_inpaint(
                req.inpaint_image, req.inpaint_mask, H, W,
                self.pipe.cfg.vae.downsample_factor)
        if req.init_image is not None:
            import cv2

            src = cv2.resize(HWC3(req.init_image), (W, H), interpolation=cv2.INTER_AREA)
            p.init_src = src.astype(np.float32) / 127.5 - 1.0
            p.t_enc = max(1, min(req.ddim_steps, int(round(
                req.denoise_strength * req.ddim_steps))))

    def submit_async(self, req: GenRequest) -> Future:
        """Like `submit`, with the host work on the server's worker pool: a
        single-threaded client's annotation of request N+1 overlaps the card's
        batch N. Errors of the host work (out-of-range knobs, a missing
        inpaint mask) surface through the returned Future."""
        if self._thread is None:
            raise RuntimeError("server not started — call start()")
        from concurrent.futures import ThreadPoolExecutor

        if self._pre_pool is None:
            self._pre_pool = ThreadPoolExecutor(
                max_workers=max(1, self._preprocess_workers),
                thread_name_prefix="sdeo-preprocess")
        fut: Future = Future()

        def _chain(inner: Future):
            e = inner.exception()
            if e is not None:
                _resolve(fut, exc=e)
            else:
                _resolve(fut, inner.result())

        def _run():
            try:
                self.submit(req).add_done_callback(_chain)
            except Exception as e:  # noqa: BLE001 — host-work error -> future
                _resolve(fut, exc=e)

        self._pre_pool.submit(_run)
        return fut

    def generate(self, req: GenRequest, timeout: float = 600.0):
        """Synchronous convenience wrapper."""
        return self.submit(req).result(timeout=timeout)

    # ------------------------------------------------------------- scheduling

    def _key(self, p: _Pending) -> Tuple:
        r = p.req
        hint_kind = (("multi", len(p.hint)) if isinstance(p.hint, tuple)
                     else p.hint.ndim)  # 2 = bit-packed, 3 = uint8 pixels
        ctx_len = int(np.prod(p.ids.shape[1:]))  # rank-3 = windowed F*77
        return (p.hw, r.ddim_steps, r.sampler, r.guess_mode, r.eta,
                r.encoder_cache_interval, r.clip_skip, ctx_len,
                hint_kind,
                p.inpaint_src is not None,  # inpaint = own engine variant
                p.t_enc,  # img2img entry step = own engine depth (0 = off)
                float(r.cfg_rescale),  # static per engine variant
                float(r.tome_ratio))  # static per engine variant

    def _cut_batch(self) -> Optional[List[_Pending]]:
        """Called under the lock. Returns the batch to run now, or None.
        Groups are tried oldest request first; a group holding for its
        window does not block a younger group that is ready."""
        # purge abandoned requests (HTTP handlers that timed out and
        # cancelled their Future)
        for k in list(self._groups):
            q = [p for p in self._groups[k] if not p.future.cancelled()]
            if q:
                self._groups[k] = q
            else:
                del self._groups[k]
        keys = list(self._groups.keys())
        now = time.perf_counter()
        ages = [(now - self._groups[k][0].t_submit) * 1e3 for k in keys]
        while True:
            gi = pick_group(ages)
            if gi < 0:
                return None
            q = self._groups[keys[gi]]
            q_ages = [(now - p.t_submit) * 1e3 for p in q]
            n = decide_cut(q_ages, self.buckets, self.max_batch,
                           self.max_wait_ms)
            if n > 0:
                batch, self._groups[keys[gi]] = q[:n], q[n:]
                if not self._groups[keys[gi]]:
                    del self._groups[keys[gi]]
                # decide_cut cuts below the largest bucket only once the
                # window has run out
                self.stats.cuts["full" if n >= self.max_batch else "window"] += 1
                t_cut = time.perf_counter()
                for p in batch:
                    p.t_cut = t_cut
                return batch
            ages[gi] = -1.0  # holding: mask and consult the next group

    def _wait_timeout(self) -> Optional[float]:
        """Called under the lock: seconds until the first group's batching
        window ends (None = wait for arrivals only)."""
        best = None
        now = time.perf_counter()
        for q in self._groups.values():
            d = next_deadline_ms([(now - p.t_submit) * 1e3 for p in q],
                                 self.max_wait_ms)
            if d >= 0 and (best is None or d < best):
                best = d
        return None if best is None else best / 1e3

    def _dispatch_loop(self):
        rt = self.pipe.runtime
        # grad mode and the current stream are per thread: set this thread's
        stream = torch.cuda.Stream(rt.device) if rt.device.type == "cuda" else None
        with torch.no_grad(), (torch.cuda.stream(stream) if stream is not None
                               else contextlib.nullcontext()):
            while True:
                with self._wake:
                    batch = (self._cut_batch()
                             if self._inflight_batches < self.max_inflight_batches
                             else None)
                    while batch is None and not self._stop:
                        at_depth = self._inflight_batches >= self.max_inflight_batches
                        # at depth only a completion can unblock us
                        t_wait = time.perf_counter()
                        self._wake.wait(timeout=None if at_depth
                                        else self._wait_timeout())
                        if at_depth:
                            self.stats.at_depth_s += time.perf_counter() - t_wait
                        if self._inflight_batches < self.max_inflight_batches:
                            batch = self._cut_batch()
                    if batch is None and self._stop:
                        return
                    self._inflight += [p.future for p in batch]
                    self._inflight_batches += 1
                try:
                    with self._device_lock:
                        self._dispatch_batch(batch)
                except Exception as e:  # noqa: BLE001 — fail the requests, not the server
                    for p in batch:
                        _resolve(p.future, exc=e)
                    with self._wake:
                        self.stats.errors += len(batch)
                        self._release(batch)

    def _release(self, batch: List[_Pending]) -> None:
        """Called under the lock: the batch is no longer in flight."""
        done = {p.future for p in batch}
        self._inflight = [f for f in self._inflight if f not in done]
        self._inflight_batches -= 1
        self._wake.notify_all()

    # -------------------------------------------------------------- execution

    def _batch_call(self, batch: List[_Pending]) -> Dict:
        """Everything the device work of a cut needs, as host values (the
        message rank 0 of a mesh runtime broadcasts): ids, hints, seeds,
        sizes and the request knobs the cut shares."""
        r0 = batch[0].req
        b = len(batch)
        # one batched CLIP call: rows [cond_0..cond_{B-1}, uncond_0..]
        ids = np.concatenate([np.stack([p.ids[0] for p in batch]),
                              np.stack([p.ids[1] for p in batch])])
        emph_w = None
        if any(p.weights is not None for p in batch):
            ones = np.ones_like(ids[0], np.float32)
            emph_w = np.concatenate(
                [np.stack([p.weights[0] if p.weights is not None else ones
                           for p in batch]),
                 np.stack([p.weights[1] if p.weights is not None else ones
                           for p in batch])])
        if isinstance(batch[0].hint, tuple):  # multi-ControlNet
            n_nets = len(batch[0].hint)
            hint = tuple(np.stack([p.hint[n] for p in batch]) for n in range(n_nets))

            def st(p, n):  # a number is every net's, a sequence one a net
                s = p.req.strength
                return s[n] if isinstance(s, (tuple, list)) else s

            strengths = tuple(np.asarray([st(p, n) for p in batch], np.float32)
                              for n in range(n_nets))
        else:
            hint = np.stack([p.hint for p in batch])
            strengths = np.asarray([p.req.strength for p in batch], np.float32)

        return dict(
            b=b, ids=ids, emph_w=emph_w, clip_skip=r0.clip_skip, hint=hint,
            scales=np.asarray([p.req.scale for p in batch], np.float32),
            strengths=strengths, seeds=[p.seed for p in batch],
            inpaint_src=(None if batch[0].inpaint_src is None
                         else np.stack([p.inpaint_src for p in batch])),
            inpaint_mask=(None if batch[0].inpaint_src is None
                          else np.stack([p.inpaint_mask for p in batch])),
            init_src=(np.stack([p.init_src for p in batch]) if batch[0].t_enc else None),
            t_enc=batch[0].t_enc,
            knobs=dict(num_steps=r0.ddim_steps, eta=r0.eta, guess_mode=r0.guess_mode,
                       sampler=r0.sampler,
                       encoder_cache_interval=r0.encoder_cache_interval,
                       cfg_rescale=r0.cfg_rescale, tome_ratio=r0.tome_ratio))

    def _run_call(self, call: Dict) -> torch.Tensor:
        """The device work of a cut: the CLIP call, the encodes of
        inpainting or img2img sources, the fused engine; the images on the
        device."""
        rt = self.pipe.runtime
        b, ids = call["b"], call["ids"]
        if ids.ndim == 3:  # long-prompt windows: (2B, F, 77) -> (2B*F, 77)
            n2b, fw, lw = ids.shape
            ctx = rt.encode_prompt(ids.reshape(n2b * fw, lw), clip_skip=call["clip_skip"])
            ctx = ctx.reshape(n2b, fw * lw, -1)
        else:
            ctx = rt.encode_prompt(ids, clip_skip=call["clip_skip"])
        if call["emph_w"] is not None:
            from stablediffusioneo_tpu_torch.models.text_encoding import apply_emphasis

            ctx = apply_emphasis(ctx, call["emph_w"])
        extra_kw = {}
        if call["inpaint_src"] is not None:
            # one batched posterior-mode encode: no batch-dependent noise
            extra_kw.update(
                inpaint_latent=rt.encode_image(call["inpaint_src"], deterministic=True),
                inpaint_mask=call["inpaint_mask"])
        if call["t_enc"]:
            extra_kw.update(
                init_latent=rt.encode_image(call["init_src"], deterministic=True),
                t_enc=call["t_enc"])
        knobs = dict(call["knobs"])
        return rt.sample_decode(
            knobs.pop("num_steps"), None, call["hint"], ctx[:b], ctx[b:],
            seeds=call["seeds"], guidance_scale=call["scales"],
            strength=call["strengths"], **knobs, **extra_kw)

    def _dispatch_batch(self, batch: List[_Pending]):
        """Encode the prompts and enqueue the batched engine call on this
        thread's stream, inside the batch's `serving.dispatch` span; hand
        the copied output and the `ready` event recorded after it (the
        span's end event, or a plain one with tracing off) to the completion
        thread, so that the next batch can be cut and enqueued while this
        one computes and is fetched. On a mesh runtime the cut is first
        published to the other ranks (`follow`)."""
        rt = self.pipe.runtime
        t0 = time.perf_counter()
        n_engines = len(rt._engines)
        with profiling.span("serving.dispatch", requests=tuple(p.rid for p in batch),
                            device=rt.device, attrs={"batch": len(batch)}) as span:
            call = self._batch_call(batch)
            self._publish(("batch", call))
            images_dev = self._run_call(call)
        ready = span.end_event  # after the copy of the engine's static output
        if ready is None and images_dev.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        with self._wake:
            if len(rt._engines) != n_engines:
                self.stats.engines = rt.engine_census()
            self._fetching += 1
        self._done_q.put((batch, images_dev, ready, t0, span))

    def _fetch(self, images_dev: torch.Tensor, ready) -> Tuple[np.ndarray, float]:
        """The batch's images on the host (completion thread): wait for the
        event recorded after the copy, then copy to the host. Also returns
        the host time the wait ended."""
        if ready is not None:
            ready.synchronize()
        t_seen = time.perf_counter()
        return images_dev.cpu().numpy(), t_seen

    def _batch_spans(self, batch: List[_Pending], span, t_seen: float,
                     t_done: float) -> List[profiling.Span]:
        """A fetched batch's spans (completion thread, after the wait for
        `ready`, so their device times resolve): `serving.dispatch` and what
        ran inside it (text.encode, runtime.engine), `serving.behind` (with a
        device time), `serving.fetch`, and each request's `serving.prep`,
        `serving.queue` and `serving.request`. Empty with tracing off."""
        if not span:
            return []
        profiling.resolve(span)
        out = [span, *(span.children or ())]
        if span.device_ms is not None:
            device_start = max(span.t0, t_seen - span.device_ms / 1e3)
            out.append(profiling.record("serving.behind", span.t0, device_start,
                                        span.requests, parent=span.id))
        out.append(profiling.record("serving.fetch", t_seen, t_done, span.requests,
                                    parent=span.id))
        for p in batch:
            if p.prep:
                out.append(p.prep)
            out.append(profiling.record("serving.queue", p.t_enq, p.t_cut, (p.rid,),
                                        parent=p.rid))
            out.append(profiling.record("serving.request", p.t_submit, t_done, (p.rid,),
                                        id=p.rid))
        return [sp for sp in out if sp is not None]

    def _complete_loop(self):
        while True:
            item = self._done_q.get()
            if item is None:
                return
            batch, images_dev, ready, t0, span = item
            try:
                images, t_seen = self._fetch(images_dev, ready)
                b = len(batch)
                spans = self._batch_spans(batch, span, t_seen, time.perf_counter())
                with self._lock:
                    self.stats.batches += 1
                    self.stats.rows += b
                    self.stats.queue_ms_sum += sum(
                        (t0 - p.t_submit) * 1e3 for p in batch)
                    self.stats.batch_hist[b] = self.stats.batch_hist.get(b, 0) + 1
                    self.stats.add_spans(spans)
                for i, p in enumerate(batch):
                    _resolve(p.future, (p.detected_map, images[i]))
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self.stats.errors += len(batch)
                for p in batch:
                    _resolve(p.future, exc=e)
            finally:
                # drop the device tensor before the batch counts as fetched
                del images_dev, ready, item, span
                with self._wake:
                    self._fetching -= 1
                    self._release(batch)
