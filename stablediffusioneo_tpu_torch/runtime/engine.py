"""Engine layer: one captured program per variant and shape (counterpart of
stablediffusioneo_tpu/runtime/engine.py).

  JAX package                          this port, on one NVIDIA card
  -----------------------------------  -----------------------------------
  jax.jit(...).lower(shapes).compile() the function run once eagerly, then
                                       captured into a torch.cuda.CUDAGraph
  the compiled lax.scan program        the replayed graph: the whole DDIM
                                       loop (+ VAE decode + uint8) is one
                                       launch from the host
  donated / abstract arguments         static input buffers the arguments
                                       are copied into; a static output
  schedules as engine inputs           the schedule's constants are baked
                                       into the capture (the samplers take
                                       them as float32 host scalars), so
                                       (sampler with its spacing, steps,
                                       eta, tail) are in the key
  in-graph random numbers              every random number is drawn outside
                                       the graph and handed in (seeds= draws
                                       each row from its own generator)
  hint variants: float, uint8          the same, unpacked / normalised in the
  (_with_u8_hint), bit-packed          graph; "multi": one float hint and
  (_with_packed_hint), multi           one scale matrix a net
  cost_analysis / memory_analysis      graph nodes, bytes of the graph's pool

`Engine` wraps one function; `CNSDRuntime` holds the four networks on one
device in the compute dtype (cast once at construction; with
quantize_linears=True the UNet's and ControlNet's eligible linears are then
converted to int8 weight-only form, in a copy of the caller's model) and a
dictionary of engines built at first use: CLIP encode, the DDIM loop (from
noise, or from a re-noised init latent over the schedule's tail; DDIM or
one of the other samplers, with or without token merging), the VAE
decode with the uint8 denormalisation, loop + decode fused, and the VAE
encode (posterior mode, or a sample with the noise handed in) for img2img and
inpainting. On the CPU, and with graphs=False, an engine runs its function
eagerly: the same code, launched op by op from the host. A model with N
ControlNets (models/cldm.py, multi-ControlNet) takes a tuple of N hints and
strengths, one a net. `apply_lora` merges an adapter into the resident
weights in place, so the captured engines replay it without a new capture.

The ControlNet-free families have free-standing engines over their models
(no runtime; a capture is the port's counterpart of the jax.jit the JAX
package runs these loops under):
`sdxl_sample_decode_engine` (SDXL base), `sdxl_refine_decode_engine` (the
refiner's tail), `concat_sample_decode_engine` (the 9-channel inpainting
model) and `encoder_engine` (its masked-image encode).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import gc
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stablediffusioneo_tpu_torch.config import PipelineConfig
from stablediffusioneo_tpu_torch.models.cldm import ControlLDM
from stablediffusioneo_tpu_torch.models.clip import clip_text_apply
from stablediffusioneo_tpu_torch.models.controlnet import guess_mode_scales
from stablediffusioneo_tpu_torch.models.unet import encoder_plan
from stablediffusioneo_tpu_torch.models.vae import vae_decode, vae_encode
from stablediffusioneo_tpu_torch.ops import dispatch, quant
from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
from stablediffusioneo_tpu_torch.ops.tome import tome_of
from stablediffusioneo_tpu_torch.parallel.mesh import (
    all_gather,
    local_slice,
    shard_params,
    spatial,
    spatial_modules,
)
from stablediffusioneo_tpu_torch.pipeline.ddim import (
    ddim_sample,
    schedule_tail,
    stochastic_encode,
)
from stablediffusioneo_tpu_torch.pipeline.dpm_solver import dpmpp_sample, dpmpp_schedule
from stablediffusioneo_tpu_torch.pipeline.k_diffusion import (
    KDIFF_SAMPLERS,
    kdiff_sample,
    kdiff_schedule,
)
from stablediffusioneo_tpu_torch.pipeline.plms import plms_sample
from stablediffusioneo_tpu_torch.pipeline.unipc import unipc_sample
from stablediffusioneo_tpu_torch.runtime import profiling

log = logging.getLogger("stablediffusioneo_tpu_torch")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# resize_image rounds to multiples of 64, so this small set covers the
# resolutions a deployment captures engines for.
DEFAULT_BUCKETS = (256, 320, 384, 448, 512, 640, 768)


# the loops other than DDIM's, by canonical sampler name
_ODE_SAMPLERS = {"plms": plms_sample, "dpmpp": dpmpp_sample, "unipc": unipc_sample}


def _canon_sampler(sampler: str) -> str:
    """A sampler string without its spacing suffix ("-karras" / "-uniform"):
    the engine's name and the loop it runs. The port's engine key keeps the
    whole string, since the spacing's schedule is baked into a capture."""
    for suffix in ("-karras", "-uniform"):
        if sampler.endswith(suffix):
            return sampler[: -len(suffix)]
    return sampler


def _noisy_steps(sampler: str, sched: Dict[str, np.ndarray]) -> np.ndarray:
    """The steps that add fresh noise: DDIM's with sigma > 0, Euler-a's with
    sigk_up > 0, none of the deterministic solvers'."""
    base = _canon_sampler(sampler)
    if base == "ddim":
        return sched["sigmas"] > 0
    if base == "euler-a":
        return sched["sigk_up"] > 0
    return np.zeros(len(next(iter(sched.values()))), bool)


def resolution_buckets(buckets=DEFAULT_BUCKETS):
    return tuple(sorted(buckets))


def snap_to_bucket(value: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= value (the shape an engine is captured at)."""
    for b in sorted(buckets):
        if b >= value:
            return b
    return sorted(buckets)[-1]


def _graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes (kernels, copies, memsets) of a captured graph that was kept
    beside its executable (keep_graph=True), by libcuda's cuGraphGetNodes."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return count.value


class Engine:
    """One function as one captured program (the JAX package's Engine).

    capture=True (CUDA): `load(*example)` copies the example tensors into
    contiguous static buffers, runs the function once eagerly on a side
    stream (which settles what a first call settles: kernel attributes,
    library handles and workspaces, cached constants), captures a second run
    into a CUDA graph with a memory pool of its own, and instantiates it;
    `compile_seconds` is all of that. A call copies its arguments into the
    static buffers, replays the graph on the current stream and returns the
    static output, which the next call overwrites. A capture that fails
    raises: there is no eager fallback behind a captured engine.

    capture=False (the CPU, or graphs=False): a call runs the function on
    contiguous copies of its arguments, as a captured engine's static
    buffers are: a convolution may take another algorithm on another memory
    layout, and the norm kernels, which keep their input's layout, sum in
    another order, and then a replay and an eager call would give other
    bytes (an img2img init latent straight from the encoder is a channel
    slice of NCHW memory). Copies, not `contiguous()`: that keeps a view
    whose size-1 dims carry other strides, from which `torch.cat` takes
    another layout (depth2img's (B, h, w, 1) depth channel, a permuted
    view, made the UNet's input NCHW where the buffer made it
    channels-last).

    Launch counters (ops/dispatch.py) count in Python, so a replay would
    leave them standing: the engine takes back what its capture counted
    (that run put nothing on the device) and adds the same counts at every
    replay.

    All arguments are tensors, and the output is a tensor or a tuple of them.
    """

    def __init__(self, fn: Callable, name: str = "engine", capture: bool = False):
        self.name = name
        self._fn = fn
        self._capture = capture
        self._graph = None
        self._inputs: List[torch.Tensor] = []
        self._output = None
        self._counts: List[dict] = []
        self._pool_bytes: Optional[int] = None
        self._device_ops: Optional[int] = None
        self.compile_seconds: Optional[float] = None
        self._span_attrs: Optional[Dict[str, Any]] = None

    def load(self, *example: torch.Tensor) -> "Engine":
        if not self._capture:
            return self
        t0 = time.perf_counter()
        device = example[0].device
        self._inputs = [a.clone(memory_format=torch.contiguous_format) for a in example]
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), torch.no_grad():
            self._fn(*self._inputs)
        stream.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = dispatch.counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept: its nodes are counted
        with torch.cuda.graph(graph, stream=stream), torch.no_grad():
            self._output = self._fn(*self._inputs)
        self._counts = dispatch.counts_since(before)
        dispatch.add_counts(self._counts, -1)  # the capture launched nothing
        graph.instantiate()  # a kept graph is instantiated by its owner
        self._pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self._device_ops = _graph_nodes(graph)
        self._graph = graph
        self.compile_seconds = time.perf_counter() - t0
        log.info("engine %s captured in %.1fs", self.name, self.compile_seconds)
        return self

    def _span(self, first: torch.Tensor):
        """The `runtime.engine` span of a call (profiling.span): attributes
        the engine's name and batch (the first argument's leading size at
        the first call), device time on the current stream."""
        if self._span_attrs is None:
            self._span_attrs = {"engine": self.name, "batch": int(first.shape[0])}
        return profiling.span("runtime.engine", device=first.device, attrs=self._span_attrs)

    def __call__(self, *args: torch.Tensor):
        if not self._capture:
            with torch.no_grad(), self._span(args[0]):
                return self._fn(*(a.clone(memory_format=torch.contiguous_format)
                                  for a in args))
        if self._graph is None:
            self.load(*args)
        if len(args) != len(self._inputs):
            raise ValueError(f"engine {self.name} takes {len(self._inputs)} "
                             f"tensors, got {len(args)}")
        for buf, a in zip(self._inputs, args):
            if a.shape != buf.shape:
                raise ValueError(f"engine {self.name} was captured for "
                                 f"{tuple(buf.shape)}, got {tuple(a.shape)}")
        with self._span(args[0]):
            for buf, a in zip(self._inputs, args):
                buf.copy_(a, non_blocking=True)
            self._graph.replay()
        dispatch.add_counts(self._counts)
        return self._output

    infer = __call__

    @property
    def compiled(self) -> bool:
        return self._graph is not None

    def replay(self) -> None:
        """Replay on the static buffers as they stand (measurements)."""
        self._graph.replay()
        dispatch.add_counts(self._counts)

    def get_engine_infor(self) -> Dict[str, Any]:
        if self._graph is None:
            return {"compiled": False}
        return {
            "compiled": True,
            "compile_seconds": self.compile_seconds,
            "device_ops": self._device_ops,
            "memory": {
                "pool_bytes": self._pool_bytes,
                "argument_bytes": sum(t.numel() * t.element_size()
                                      for t in self._inputs),
            },
        }


def decode_u8(vae, z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Scaled latents -> uint8 NHWC pixels: the VAE decode in `dtype`, then
    the denormalisation in fp32."""
    img = vae_decode(vae, z.to(dtype), scaled=True)
    return torch.clamp(img.float() * 127.5 + 127.5, 0, 255).to(torch.uint8)


def _encode_fn(vae, deterministic: bool) -> Callable:
    """The VAE encode to scaled latents (the scale factor rounded to the
    image's dtype, as in vae_decode): posterior mode, or a sample with the
    noise eps handed in."""
    def scaled(img, z):
        return z * dispatch.const_tensor(float(vae.cfg.scale_factor), img.dtype,
                                         img.device)

    if deterministic:
        return lambda img: scaled(img, vae_encode(vae, img).mode())
    return lambda img, eps: scaled(img, vae_encode(vae, img).sample(eps))


def _model_engine(model, name: str, fn: Callable, example, capture: Optional[bool]
                  ) -> Engine:
    """An Engine of fn over a model's networks, captured on example inputs
    ((shape, dtype) pairs) where the model lies on a CUDA device (capture
    None) or where capture is True, else eager."""
    p = next(model.parameters())
    capture = p.device.type == "cuda" if capture is None else capture
    eng = Engine(fn, name=name, capture=capture)
    if capture:
        eng.load(*(torch.zeros(shape, dtype=dt, device=p.device) for shape, dt in example))
    return eng


def encoder_engine(model, batch: int, h: int, w: int, deterministic: bool = False,
                   capture: Optional[bool] = None) -> Engine:
    """The VAE encode of a model without a runtime (a LatentDiffusion: the
    inpainting family's masked-image encode) as one Engine, the function and
    name of CNSDRuntime.encoder_engine: NHWC pixels (B, H, W, 3) in [-1, 1]
    in the compute dtype [, eps] -> scaled latents (B, H/8, W/8, 4)."""
    vae = model.first_stage_model
    f = vae.cfg.downsample_factor
    dtype = next(model.parameters()).dtype
    lat = (batch, h // f, w // f, vae.cfg.embed_dim)
    return _model_engine(
        model, f"encoder_b{batch}_{h}x{w}" + ("_det" if deterministic else ""),
        _encode_fn(vae, deterministic),
        [((batch, h, w, 3), dtype)] + ([] if deterministic else [(lat, dtype)]), capture)


def _sdxl_engine(model, sched, name: str, batch: int, h: int, w: int,
                 capture: Optional[bool]) -> Engine:
    """The SDXL DDIM loop (base or refiner: models/sdxl.py:sdxl_txt2img over
    `sched`, eta 0) and the VAE decode to uint8 as one Engine taking (x
    (B, h/8, w/8, 4), ctx_cond, ctx_uncond (B, 77, context) in the compute
    dtype, y_cond, y_uncond (B, adm) fp32, scale (B,) fp32) and returning
    (image uint8 (B, h, w, 3), x_0 latents fp32)."""
    from stablediffusioneo_tpu_torch.models.sdxl import sdxl_txt2img

    cfg = model.cfg
    dtype = next(model.unet.parameters()).dtype

    def run(x, ctx_cond, ctx_uncond, y_cond, y_uncond, scale):
        z = sdxl_txt2img(model.unet, sched, x, ctx_cond, ctx_uncond, y_cond, y_uncond,
                         scale, dtype=dtype, parameterization=cfg.diffusion.parameterization)
        return decode_u8(model.vae, z, dtype), z

    f = cfg.vae.downsample_factor
    ctx = (batch, cfg.clip_g.max_length, cfg.unet.context_dim)
    adm = (batch, cfg.unet.adm_in_channels)
    return _model_engine(model, name, run, (
        ((batch, h // f, w // f, 4), dtype), (ctx, dtype), (ctx, dtype),
        (adm, torch.float32), (adm, torch.float32), ((batch,), torch.float32)), capture)


def _ddim_schedule(cfg, num_steps: int):
    d = cfg.diffusion
    return DiffusionSchedule(d.timesteps, d.linear_start, d.linear_end,
                             d.schedule).ddim(num_steps)


def sdxl_sample_decode_engine(model, num_steps: int, batch: int, h: int, w: int,
                              capture: Optional[bool] = None) -> Engine:
    """SDXL base txt2img as ONE captured program, as the JAX package captures
    it (cli/bench.py `_bench_sdxl`): the DDIM loop (models/sdxl.py:
    sdxl_txt2img, eta 0, the schedule baked in) and the VAE decode to uint8,
    with the conditioning computed outside it. `model` is an SDXL
    (models/sdxl.py) on its device in its compute dtype. Inputs and outputs:
    `_sdxl_engine` (contexts (B, 77, 2048), y (B, 2816)). capture: None
    captures on a CUDA device and runs eagerly on the CPU."""
    return _sdxl_engine(model, _ddim_schedule(model.cfg, num_steps),
                        f"sdxl+decode_{num_steps}x{batch}x{h}x{w}", batch, h, w, capture)


def sdxl_refine_decode_engine(model, num_steps: int, t_enc: int, batch: int, h: int,
                              w: int, capture: Optional[bool] = None) -> Engine:
    """The SDXL refiner's half of the base -> refiner handoff as ONE captured
    program: the DDIM loop over the last t_enc of num_steps steps (eta 0,
    the tail baked in) and the VAE decode to uint8. `model` is an SDXLRefiner
    (models/sdxl.py) on its device in its compute dtype. Its x is the entry
    latent: the base model's latents forward-diffused to the tail's entry
    step outside the graph (pipeline/ddim.py:stochastic_tail_entry, noise
    drawn outside); contexts (B, 77, 1280) from bigG, y (B, 2560)
    (sdxl_refiner_conditioning, one call a branch); the rest as
    `_sdxl_engine`."""
    sched = schedule_tail(_ddim_schedule(model.cfg, num_steps), t_enc)
    return _sdxl_engine(model, sched,
                        f"sdxl_refine+decode_{t_enc}x{batch}x{h}x{w}_of{num_steps}",
                        batch, h, w, capture)


def concat_sample_decode_engine(model, num_steps: int, batch: int, h: int, w: int,
                                t_enc: Optional[int] = None,
                                capture: Optional[bool] = None) -> Engine:
    """A concat-conditioned model's DDIM loop (pipeline/concat_cond.py:
    sd_concat_sample, eta 0, the schedule baked in; with t_enc,
    sd_concat_img2img over the last t_enc of num_steps steps) and the VAE
    decode to uint8 as ONE captured program. `model` is a LatentDiffusion of
    a concat-conditioned configuration (config.sd15_inpaint_pipeline) on its
    device in its compute dtype. Inputs: x_T (B, h/8, w/8, 4) in the compute
    dtype (with t_enc: the init latent z0, then the entry noise, fp32), the
    conditioning channels c_concat (B, h/8, w/8, in_channels - 4) (the
    masked-image encode runs before, in `encoder_engine`), ctx_cond,
    ctx_uncond (B, 77, context) in the compute dtype, scale (B,) fp32.
    Returns (image uint8 (B, h, w, 3), x_0 latents fp32)."""
    from stablediffusioneo_tpu_torch.pipeline.concat_cond import (
        sd_concat_img2img,
        sd_concat_sample,
    )

    cfg = model.cfg
    dtype = next(model.unet.parameters()).dtype
    sched = _ddim_schedule(cfg, num_steps)
    common = dict(dtype=dtype, parameterization=cfg.diffusion.parameterization)

    if t_enc is None:
        def loop(x, c_concat, ctx_cond, ctx_uncond, scale):
            return sd_concat_sample(model.unet, sched, x, c_concat, ctx_cond, ctx_uncond,
                                    scale, **common)
    else:
        schedule_tail(sched, t_enc)  # refused here, as at the first call

        def loop(z0, renoise, c_concat, ctx_cond, ctx_uncond, scale):
            return sd_concat_img2img(model.unet, sched, z0, t_enc, c_concat, ctx_cond,
                                     ctx_uncond, scale, renoise=renoise, **common)

    def run(*args):
        z = loop(*args)
        return decode_u8(model.first_stage_model, z, dtype), z

    f = cfg.vae.downsample_factor
    lat = (batch, h // f, w // f, 4)
    ctx = (batch, cfg.clip.max_length, cfg.unet.context_dim)
    entry = [(lat, dtype)] + ([] if t_enc is None else [(lat, torch.float32)])
    return _model_engine(
        model, f"concat+decode_{t_enc or num_steps}x{batch}x{h}x{w}"
        + ("" if t_enc is None else f"_genxT-img2img_of{num_steps}"), run,
        entry + [(lat[:3] + (cfg.unet.in_channels - 4,), dtype), (ctx, dtype),
                 (ctx, dtype), ((batch,), torch.float32)], capture)


class MeshEngine:
    """An Engine over this rank's part of its arguments, on a runtime with a
    mesh (parallel/mesh.py): a call cuts each global argument to the rank's
    part by its layout, runs the engine (built, and captured on NCCL, at the
    local shapes, its function inside `mesh.spatial`, so that the collectives
    of the tensor- and row-parallel models are part of it), and gathers the
    outputs back, so that every rank returns the whole batch (the JAX
    runtime's dp-sharded and replicated outputs, which its callers read
    whole). Layouts, a string an argument or output: "b" batch on dim 0,
    "bh" batch on dim 0 and NHWC rows on dim 1, "sbh" per-step (batch on
    dim 1, rows on dim 2), "" whole. dp=False: the batch does not tile dp and
    every rank runs it whole (the JAX `_put_batch` replicated case); sp:
    the sp axis the rows are split on, or None."""

    def __init__(self, engine: Engine, mesh, layouts: Sequence[str],
                 out_layouts: Sequence[str], dp: bool, sp):
        self.engine, self.mesh = engine, mesh
        self.layouts, self.out_layouts = tuple(layouts), tuple(out_layouts)
        self.dp = mesh.axis("dp") if dp else None
        self.sp = sp
        self.name = engine.name

    def _dims(self, layout: str):
        """(axis, dim) pairs a layout splits: batch over dp, rows over sp."""
        b = layout.find("b")
        out = []
        if b >= 0 and self.dp is not None:
            out.append((self.dp, b))
        if "h" in layout and self.sp is not None:
            out.append((self.sp, layout.find("h")))
        return out

    def local(self, args) -> List[torch.Tensor]:
        out = []
        for a, lay in zip(args, self.layouts):
            for ax, d in self._dims(lay):
                a = local_slice(a, ax, d)
            out.append(a)
        return out

    def _join(self, out):
        if isinstance(out, tuple):
            return tuple(self._gather(o, lay) for o, lay in zip(out, self.out_layouts))
        return self._gather(out, self.out_layouts[0])

    def _gather(self, x, layout: str):
        for ax, d in reversed(self._dims(layout)):
            x = all_gather(x, ax, d)
        return x

    def __call__(self, *args: torch.Tensor):
        if len(args) != len(self.layouts):
            raise ValueError(f"engine {self.name} takes {len(self.layouts)} "
                             f"tensors, got {len(args)}")
        return self._join(self.engine(*self.local(args)))

    infer = __call__

    def __getattr__(self, name):  # compiled, replay, compile_seconds, ...
        return getattr(self.engine, name)


def _kept(out):
    """A copy of an engine's output that the next call does not overwrite."""
    if isinstance(out, tuple):
        return tuple(_kept(o) for o in out)
    return out.clone()


def unpack_hint(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A bit-packed binary hint (B, H, W/8) uint8, np.packbits' big-endian
    order, as the (B, H, W, 3) {0, 1} hint in `dtype` (the JAX
    _with_packed_hint): the values and layout the uint8 variant's /255 gives
    a {0, 255} map, so the two variants' images are equal in bytes."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    b, h, wp = bits.shape
    hint = ((bits[..., None] >> shifts) & 1).reshape(b, h, wp * 8).to(dtype)
    return hint[..., None].expand(b, h, wp * 8, 3).contiguous()


class CNSDRuntime:
    """model: a ControlLDM holding the weights (any device, any dtype);
    it is moved to `device` and cast to cfg.dtype in place. A ControlLDM
    of N > 1 ControlNets makes a multi-ControlNet runtime: its loops take a
    tuple of N hints (hint variant "multi").

    quantize_linears: int8 weight-only UNet and ControlNet linears
    (ops/quant.py), converted after the cast, as the JAX package does, so
    that the int8 bytes and scales are the same in both packages. The
    conversion works on a copy: the caller's model keeps its nn.Linears.

    graphs: None captures engines on a CUDA device and runs eagerly on the
    CPU; False keeps the eager loop on a CUDA device too (the attribute may
    be changed between calls: engines are cached by it); True on the CPU is
    refused.

    capture_guard: None, or a context manager factory entered around every
    capture (a server makes captures wait for the device-to-host fetches of
    other threads: a capture in torch's default global mode fails beside
    them).

    mesh: a parallel.make_mesh mesh (the JAX runtime's mesh=): every rank of
    it builds the runtime with the same model and makes the same calls. The
    runtime works on a copy of the model, sharded after the dtype cast and
    the int8 conversion, as the JAX runtime shards its params: the TP rules
    of parallel/mesh.py:shard_params (the int8 linears, which the JAX rule
    does not name, stay whole), and with an sp axis the row-mixing convs
    made halo-exchanging. Engine calls run each rank's slice of the batch
    (a batch that does not tile dp runs whole on every rank) and, with sp,
    its rows of the latents, hints and images where the latent rows tile
    sp times the UNet's downsampling; every call returns the whole result
    on every rank (`MeshEngine`). The device is the mesh's. Engines are
    captured over NCCL (the collectives in the graph); over gloo they run
    eagerly, and graphs=True is refused."""

    def __init__(self, model: ControlLDM, cfg: PipelineConfig,
                 device="cuda", quantize_linears: bool = False,
                 graphs: Optional[bool] = None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True needs a CUDA device")
        if graphs and mesh is not None and mesh.backend != "nccl":
            raise ValueError(f"graphs=True needs NCCL collectives (this mesh's "
                             f"transport: {mesh.transport})")
        self.graphs = graphs
        self.dtype = DTYPES[cfg.dtype]
        if quantize_linears or mesh is not None:
            model = copy.deepcopy(model)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.model.requires_grad_(False)
        control = self.model.control
        self.multi = isinstance(control, tuple)  # multi-ControlNet
        self.n_nets = len(control) if self.multi else 1
        if quantize_linears:
            for net in (self.model.unet, self.model.control_model):
                quant.quantize_linear_modules(net)
        self.quantized = quantize_linears
        self._sp_rows = 0  # latent rows must tile this for an sp split
        if mesh is not None:
            shard_params(self.model, mesh)
            if mesh.axis("sp") is not None:
                spatial_modules(self.model)
                self._sp_rows = mesh.size("sp") * 2 ** (len(cfg.unet.channel_mult) - 1)
        d = cfg.diffusion
        self.schedule = DiffusionSchedule(d.timesteps, d.linear_start,
                                          d.linear_end, d.schedule)
        self.n_taps = len(encoder_plan(cfg.unet)) + 1
        self._engines: Dict[Tuple, Engine] = {}
        self.last_latents: Optional[torch.Tensor] = None
        self.capture_guard: Optional[Callable] = None

    def _require_model(self) -> ControlLDM:
        if self.model is None:
            raise RuntimeError("runtime was released")
        return self.model

    @property
    def capturing(self) -> bool:
        return (self.device.type == "cuda" and self.graphs is not False
                and (self.mesh is None or self.mesh.backend == "nccl"))

    def apply_lora(self, lora: Dict, scale: float = 1.0, on: str = "unet") -> int:
        """Merge a LoRA adapter tree (training/lora.py) into the resident `on`
        network ("unet", "controlnet": with several ControlNets a tuple of
        trees or a dict keyed by position, "clip" or "vae"). The merge writes
        the weights in place, in their dtype and shapes, so every captured
        engine stays valid and its next replay reads the merged weights; no
        engine is recaptured. One-way: re-load the checkpoint to remove an
        adapter. The device is synchronized before the merge (no replay in
        flight reads a weight half merged) and after it; a running
        DiffusionServer must be drained first, since its dispatcher replays on
        a stream of its own. Returns the number of merged sites."""
        from stablediffusioneo_tpu_torch.training.lora import merge_lora

        if self.quantized:
            raise ValueError(
                "apply_lora on an int8-quantized runtime: merge before "
                "quantization (construct with quantize_linears=False, "
                "apply, then quantize)")
        model = self._require_model()
        nets = {"unet": model.unet, "controlnet": model.control, "clip": model.clip,
                "vae": model.first_stage_model}
        if on not in nets:
            raise KeyError(f"apply_lora: no {on!r} tree in runtime params")
        if self.mesh is not None:  # each rank merges its slice of the update
            from stablediffusioneo_tpu_torch.training.lora import shard_lora

            lora = shard_lora(nets[on], lora)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        n = merge_lora(nets[on], lora, scale)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    # ------------------------------------------------------------- engines

    def _engine(self, key_t: Tuple, name: str, make_fn: Callable,
                example: Callable, layouts: Sequence[str] = (),
                out_layouts: Sequence[str] = (), batch: int = 0,
                rows: int = 0) -> Engine:
        """The engine of this key, built (and captured) at first use. The
        kernel flags are part of the key: they change what a capture holds.
        With a mesh, a MeshEngine over the arguments' `layouts` (batch: the
        global batch; rows: the latent rows, 0 where nothing is split by
        rows)."""
        key_t = key_t + (self.capturing, dispatch.kernel_flags())
        eng = self._engines.get(key_t)
        if eng is None:
            fn, mesh = make_fn(), self.mesh
            if mesh is not None:
                sp = (mesh.axis("sp") if self._sp_rows and rows
                      and rows % self._sp_rows == 0 else None)
                inner = fn

                def fn(*a):
                    with spatial(sp):
                        return inner(*a)

            eng = Engine(fn, name=name, capture=self.capturing)
            if mesh is not None:
                eng = MeshEngine(eng, mesh, layouts, out_layouts,
                                 batch % mesh.size("dp") == 0, sp)
            if self.capturing:
                ex = example()
                if mesh is not None:
                    ex = eng.local(ex)
                with self.capture_guard() if self.capture_guard else contextlib.nullcontext():
                    eng.load(*ex)
            self._engines[key_t] = eng
        return eng

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _make_schedule(self, num_steps: int, sampler: str, eta: float = 0.0):
        """The schedule of a sampler string (the JAX runtime's, refusals and
        words included): dpmpp and unipc on `dpmpp_schedule` (uniform unless
        "-karras"), the k-diffusion samplers on `kdiff_schedule` (Karras
        unless "-uniform"), PLMS (eta 0 only) and DDIM on the DDIM one."""
        spacing = "karras" if sampler.endswith("-karras") else "uniform"
        base = _canon_sampler(sampler)
        if base in ("dpmpp", "unipc"):
            return dpmpp_schedule(self.schedule, num_steps, spacing=spacing)
        if base in KDIFF_SAMPLERS:
            sp = "uniform" if sampler.endswith("-uniform") else "karras"
            return kdiff_schedule(self.schedule, num_steps, spacing=sp)
        if base == "plms":
            if float(eta) != 0.0:
                raise ValueError(
                    f"PLMS requires eta == 0 (got {eta}); the upstream "
                    "PLMSSampler asserts ddim_eta == 0")
            return self.schedule.ddim(num_steps, eta=0.0)
        if base != "ddim":
            raise ValueError(f"unknown sampler {sampler!r} (expected 'ddim', "
                             "'plms', 'dpmpp[-karras]', 'unipc[-karras]', "
                             "'euler[-a|-uniform]' or 'heun[-uniform]')")
        return self.schedule.ddim(num_steps, eta=eta)

    def check_sampler(self, sampler: str = "ddim", eta: float = 0.0,
                      encoder_cache_interval: int = 1, inpaint: bool = False,
                      img2img: bool = False) -> float:
        """The JAX runtime's refusals of a sampler and what it is combined
        with, with its error types and words, before any work: img2img (and
        so the hires refine), encoder caching and inpainting are DDIM-path
        features; an unknown name; PLMS with eta != 0. Returns the eta the
        loop runs with: the other solvers ignore it (0.0)."""
        base = _canon_sampler(sampler)
        if img2img and base != "ddim":
            raise ValueError("img2img (init_image/denoise_strength) is a "
                             f"DDIM-path feature (sampler='ddim', got {base!r})")
        if encoder_cache_interval != 1 and base != "ddim":
            raise ValueError(
                "encoder_cache_interval is a DDIM-path feature "
                f"(sampler='ddim'); got interval {encoder_cache_interval} "
                f"with sampler {base!r}")
        if inpaint and base != "ddim":
            raise ValueError("inpainting is a DDIM-path feature "
                             "(sampler='ddim')")
        self._make_schedule(1, sampler, eta)
        return float(eta) if base == "ddim" else 0.0

    def _loop_schedule(self, num_steps: int, schedule_steps: Optional[int],
                       eta: float, sampler: str = "ddim"):
        """The schedule an engine of `num_steps` steps bakes in: that of
        schedule_steps steps (default num_steps), cut to its last num_steps
        (a tail: DDIM only)."""
        sched = self._make_schedule(schedule_steps or num_steps, sampler, eta)
        if (schedule_steps or num_steps) == num_steps:
            return sched
        return schedule_tail(sched, num_steps)

    def _check_hint_variant(self, hint_u8) -> None:
        if hint_u8 not in (False, True, "packed", "multi"):
            raise ValueError(f"unknown hint variant {hint_u8!r} (False, True, "
                             "'packed' or 'multi')")
        if (hint_u8 == "multi") != self.multi:
            raise ValueError("multi-ControlNet: hint must be a tuple of per-net "
                             "float hints iff the runtime holds a tuple of "
                             f"ControlNets (this one holds {self.n_nets})")

    def _sampler_fn(self, num_steps: int, guess_mode: bool,
                    encoder_cache_interval: int, hint_u8, gen_xT,
                    inpaint: bool, cfg_rescale: float, eta: float,
                    schedule_steps: Optional[int], sampler: str = "ddim",
                    tome_ratio: float = 0.0) -> Callable:
        """The sampler's loop as a function of tensors only:
        (x, hint, ctx_cond, ctx_uncond, scale (B,), control scales (B, taps)
        (hint_u8 "multi": N hints, then ctx_cond, ctx_uncond, scale, then N
        control scales, one a net)
        [, step noise (steps, B, h, w, 4) when a step adds noise: DDIM with
        eta > 0, Euler-a]
        [, re-noise (B, h, w, 4) when gen_xT == "img2img": x is then the init
        latent] [, inpaint latent, inpaint mask, inpaint noise (steps, ...)])
        -> x_0 latents, fp32 NHWC. The arguments have passed `check_sampler`
        (eta is the one the loop reads). tome_ratio > 0 merges tokens in both
        nets (the JAX `_cfg_with_tome`; the other settings from the
        ControlNet's UNet configuration), bound here for the engine's life."""
        if gen_xT not in (False, "img2img"):
            raise NotImplementedError(
                f"engine variant gen_xT={gen_xT!r}: the port draws x_T outside "
                "the graph (x_T=, seeds= or generator=)")
        if encoder_cache_interval < 1:
            raise ValueError("encoder_cache_interval must be >= 1")
        model, dtype = self._require_model(), self.dtype
        n_hints = self.n_nets if hint_u8 == "multi" else 1
        sched = self._loop_schedule(num_steps, schedule_steps, eta, sampler)
        noisy = bool(_noisy_steps(sampler, sched).any())
        base = _canon_sampler(sampler)
        common = dict(guess_mode=guess_mode, dtype=dtype, cfg_rescale=cfg_rescale,
                      parameterization=self.cfg.diffusion.parameterization,
                      tome=tome_of(self.cfg.controlnet.unet, tome_ratio))

        def norm(hint):
            if hint_u8 == "packed":
                return unpack_hint(hint, dtype)
            if hint.dtype == torch.uint8:  # /255 in fp32, then the compute dtype
                hint = hint.float() / 255.0
            return hint.to(dtype)

        def run(x, *rest):
            rest = list(rest)
            hints = [norm(rest.pop(0)) for _ in range(n_hints)]
            ctx_cond, ctx_uncond, scale = rest.pop(0), rest.pop(0), rest.pop(0)
            cscales = [rest.pop(0) for _ in range(n_hints)]
            noise = rest.pop(0) if noisy else None
            if gen_xT == "img2img":
                x = stochastic_encode(x, float(sched["alphas"][0]), rest.pop(0))
            one = hint_u8 != "multi"
            args = (model.unet, model.control, sched, x,
                    hints[0] if one else tuple(hints), ctx_cond, ctx_uncond, scale,
                    cscales[0] if one else tuple(cscales))
            if base in KDIFF_SAMPLERS:
                return kdiff_sample(*args, sampler=base, noise=noise, **common)
            if base != "ddim":
                return _ODE_SAMPLERS[base](*args, **common)
            ilat, imask, inoise = rest if inpaint else (None, None, None)
            return ddim_sample(
                *args, noise=noise, encoder_cache_interval=encoder_cache_interval,
                inpaint_latent=ilat, inpaint_mask=imask, inpaint_noise=inoise,
                **common)

        return run

    def _sampler_example(self, num_steps, batch, h, w, ctx_len, hint_u8, gen_xT,
                         inpaint, eta, schedule_steps, sampler="ddim"):
        f = self.cfg.vae.downsample_factor
        lat = (batch, h // f, w // f, 4)
        ctx = (batch, ctx_len, self.cfg.unet.context_dim)
        sched = self._loop_schedule(num_steps, schedule_steps, eta, sampler)
        n_hints = self.n_nets if hint_u8 == "multi" else 1
        if hint_u8 == "packed":
            hint = self._zeros((batch, h, w // 8), torch.uint8)
        else:
            hint = self._zeros((batch, h, w, 3),
                               torch.uint8 if hint_u8 is True else self.dtype)
        ex = [self._zeros(lat, self.dtype), *[hint] * n_hints,
              self._zeros(ctx, self.dtype), self._zeros(ctx, self.dtype),
              self._zeros((batch,), torch.float32),
              *[self._zeros((batch, self.n_taps), torch.float32)] * n_hints]
        if _noisy_steps(sampler, sched).any():
            ex.append(self._zeros((num_steps,) + lat, torch.float32))
        if gen_xT == "img2img":
            ex.append(self._zeros(lat, torch.float32))
        if inpaint:
            ex += [self._zeros(lat, self.dtype),
                   self._zeros(lat[:3] + (1,), self.dtype),
                   self._zeros((num_steps,) + lat, torch.float32)]
        return ex

    def _sampler_layouts(self, num_steps, hint_u8, gen_xT, inpaint, eta,
                         schedule_steps, sampler="ddim") -> List[str]:
        """The MeshEngine layouts of `_sampler_example`'s arguments."""
        sched = self._loop_schedule(num_steps, schedule_steps, eta, sampler)
        n_hints = self.n_nets if hint_u8 == "multi" else 1
        lay = ["bh"] * (1 + n_hints) + ["b"] * (3 + n_hints)
        if _noisy_steps(sampler, sched).any():
            lay.append("sbh")
        if gen_xT == "img2img":
            lay.append("bh")
        if inpaint:
            lay += ["bh", "bh", "sbh"]
        return lay

    def _decode_u8(self, z: torch.Tensor) -> torch.Tensor:
        return decode_u8(self._require_model().first_stage_model, z, self.dtype)

    def sample_decode_engine(
        self, num_steps: int, batch: int, h: int, w: int,
        guess_mode: bool = False, sampler: str = "ddim",
        encoder_cache_interval: int = 1, ctx_len: Optional[int] = None,
        hint_u8=False, gen_xT=False, inpaint: bool = False,
        cfg_rescale: float = 0.0, tome_ratio: float = 0.0,
        eta: float = 0.0, schedule_steps: Optional[int] = None,
    ) -> Engine:
        """The sampler's loop + VAE decode + uint8 denormalisation as ONE
        captured program returning (image uint8 (B, H, W, 3), x_0 latents).
        The arguments and name are the JAX package's; beyond them eta and
        schedule_steps (the full discretisation when num_steps is a tail, the
        img2img variant), which the JAX engine takes as inputs and this one
        bakes in, as it bakes in the sampler's spacing: the key holds the whole
        sampler string ("dpmpp-karras" is not "dpmpp") and the eta the loop
        reads (0.0 for the solvers that ignore it). hint_u8: True, the hint is
        uint8 pixels, normalised in the graph; "packed", a bit-packed binary
        map (B, H, W/8) uint8, unpacked in the graph (`unpack_hint`); "multi",
        one float hint a ControlNet (a multi-ControlNet runtime's only
        variant); False, floats. gen_xT="img2img": x is the init latent,
        re-noised in the graph with the noise handed in."""
        self._check_hint_variant(hint_u8)
        eta = self.check_sampler(sampler, eta, encoder_cache_interval, inpaint,
                                 gen_xT == "img2img")
        ctx_len = ctx_len or self.cfg.clip.max_length
        key_t = ("sample_decode", sampler, num_steps, batch, h, w, guess_mode,
                 encoder_cache_interval, ctx_len, hint_u8, gen_xT, inpaint,
                 float(cfg_rescale), float(tome_ratio), float(eta),
                 schedule_steps or num_steps)

        def make():
            sfn = self._sampler_fn(num_steps, guess_mode, encoder_cache_interval,
                                   hint_u8, gen_xT, inpaint, cfg_rescale, eta,
                                   schedule_steps, sampler, tome_ratio)

            def run(*args):
                z = sfn(*args)
                return self._decode_u8(z), z

            return run

        return self._engine(
            key_t, f"{_canon_sampler(sampler)}+decode_{num_steps}x{batch}x{h}x{w}"
            + ("_guess" if guess_mode else "")
            + ("_bithint" if hint_u8 == "packed" else "")
            + (f"_genxT-{gen_xT}" if isinstance(gen_xT, str) else "")
            + ("_inpaint" if inpaint else ""), make,
            lambda: self._sampler_example(num_steps, batch, h, w, ctx_len, hint_u8,
                                          gen_xT, inpaint, eta, schedule_steps,
                                          sampler),
            self._sampler_layouts(num_steps, hint_u8, gen_xT, inpaint, eta,
                                  schedule_steps, sampler),
            ("bh", "bh"), batch, h // self.cfg.vae.downsample_factor)

    def sampler_engine(
        self, num_steps: int, batch: int, h: int, w: int,
        guess_mode: bool = False, sampler: str = "ddim",
        encoder_cache_interval: int = 1, ctx_len: Optional[int] = None,
        hint_u8=False, cfg_rescale: float = 0.0, tome_ratio: float = 0.0,
        eta: float = 0.0, schedule_steps: Optional[int] = None,
        gen_xT=False, inpaint: bool = False,
    ) -> Engine:
        """The captured sampler loop for (steps, batch, H x W), H and W in
        image space; returns the x_0 latents. Arguments as
        `sample_decode_engine`."""
        self._check_hint_variant(hint_u8)
        eta = self.check_sampler(sampler, eta, encoder_cache_interval, inpaint,
                                 gen_xT == "img2img")
        ctx_len = ctx_len or self.cfg.clip.max_length
        key_t = ("sampler", sampler, num_steps, batch, h, w, guess_mode,
                 encoder_cache_interval, ctx_len, hint_u8, float(cfg_rescale),
                 float(tome_ratio), float(eta), schedule_steps or num_steps,
                 gen_xT, inpaint)
        return self._engine(
            key_t, f"{_canon_sampler(sampler)}_{num_steps}x{batch}x{h}x{w}"
            + ("_guess" if guess_mode else "")
            + (f"_ctx{ctx_len}" if ctx_len != self.cfg.clip.max_length else ""),
            lambda: self._sampler_fn(num_steps, guess_mode, encoder_cache_interval,
                                     hint_u8, gen_xT, inpaint, cfg_rescale, eta,
                                     schedule_steps, sampler, tome_ratio),
            lambda: self._sampler_example(num_steps, batch, h, w, ctx_len, hint_u8,
                                          gen_xT, inpaint, eta, schedule_steps,
                                          sampler),
            self._sampler_layouts(num_steps, hint_u8, gen_xT, inpaint, eta,
                                  schedule_steps, sampler),
            ("bh",), batch, h // self.cfg.vae.downsample_factor)

    def clip_engine(self, batch: int, clip_skip: int = 0) -> Engine:
        clip, dtype = self._require_model().clip, self.dtype
        return self._engine(
            ("clip", batch, clip_skip),
            f"clip_b{batch}" + (f"_skip{clip_skip}" if clip_skip > 1 else ""),
            lambda: lambda ids: clip_text_apply(clip, ids,
                                                clip_skip=clip_skip).to(dtype),
            lambda: [self._zeros((batch, self.cfg.clip.max_length), torch.long)],
            ("b",), ("b",), batch)

    def decoder_engine(self, batch: int, h: int, w: int) -> Engine:
        f = self.cfg.vae.downsample_factor
        return self._engine(
            ("decoder", batch, h, w), f"decoder_b{batch}_{h}x{w}",
            lambda: self._decode_u8,
            lambda: [self._zeros((batch, h // f, w // f, 4), self.dtype)],
            ("bh",), ("bh",), batch, h // f)

    def encoder_engine(self, batch: int, h: int, w: int,
                       deterministic: bool = False) -> Engine:
        """VAE encoder -> scaled latents (B, h/8, w/8, 4) from NHWC pixels in
        [-1, 1] in the compute dtype. deterministic=True takes the posterior
        mode; else the engine takes a second input, the sample's noise eps
        (the latents' shape, compute dtype), drawn by the caller. The scale
        factor is rounded to the image's dtype, as in vae_decode."""
        vae = self._require_model().first_stage_model
        f = self.cfg.vae.downsample_factor
        lat = (batch, h // f, w // f, self.cfg.vae.embed_dim)
        return self._engine(
            ("encoder", batch, h, w, deterministic),
            f"encoder_b{batch}_{h}x{w}" + ("_det" if deterministic else ""),
            lambda: _encode_fn(vae, deterministic),
            lambda: [self._zeros((batch, h, w, 3), self.dtype)]
            + ([] if deterministic else [self._zeros(lat, self.dtype)]),
            ("bh",) * (1 if deterministic else 2), ("bh",), batch, h // f)

    # ----------------------------------------------------------- user API

    def _out(self, out):
        """An engine's output for the caller: a captured engine's static
        output is copied, since the engine's next call overwrites it."""
        return _kept(out) if self.capturing else out

    def encode_prompt(self, ids, clip_skip: int = 0) -> torch.Tensor:
        """(N, T) token ids -> (N, T, hidden) contexts in the compute dtype
        (the `text.encode` span, device time on the current stream)."""
        with profiling.span("text.encode", device=self.device):
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                  device=self.device)
            return self._out(self.clip_engine(ids.shape[0], clip_skip)(ids))

    def encode_prompt_windowed(self, tokenizer, texts, windows=3,
                               clip_skip: int = 0) -> torch.Tensor:
        """Long-prompt contexts (B, windows * 77, hidden): the hack_everything
        3x77 windowing (cldm/hack.py:32-68). The (B, windows, 77) ids run as
        one CLIP engine call of batch B * windows. windows="auto" takes the
        fewest windows that hold the longest text (1 to 3)."""
        from stablediffusioneo_tpu_torch.models.text_encoding import (
            needed_windows,
            tokenize_windowed,
        )

        if windows == "auto":
            windows = needed_windows(tokenizer, texts)
        ids = tokenize_windowed(tokenizer, texts, windows=windows)
        b, n, length = ids.shape
        y = self.encode_prompt(ids.reshape(b * n, length), clip_skip=clip_skip)
        return y.reshape(b, n * length, -1)

    def encode_image(self, img, generator: Optional[torch.Generator] = None,
                     deterministic: bool = False,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NHWC pixels (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8,
        W/8, 4) in the compute dtype, through the encoder engine.
        deterministic=True takes the posterior mode. Otherwise the posterior
        is sampled with `eps` (the latents' shape) or, without it, noise drawn
        from `generator` before the call; with neither the call is refused,
        as the JAX runtime refuses a sample without a key."""
        img = torch.as_tensor(img, device=self.device).to(self.dtype)
        b, h, w, _ = img.shape
        eng = self.encoder_engine(b, h, w, deterministic=deterministic)
        if deterministic:
            return self._out(eng(img))
        f = self.cfg.vae.downsample_factor
        lat = (b, h // f, w // f, self.cfg.vae.embed_dim)
        if eps is None:
            if generator is None:
                raise ValueError("encode_image: generator= or eps= required "
                                 "unless deterministic=True")
            eps = torch.randn(lat, generator=generator, device=self.device)
        return self._out(eng(img, torch.as_tensor(eps, device=self.device)
                             .to(self.dtype)))

    def _per_sample_scales(self, batch: int, guidance_scale, strength,
                           guess_mode: bool):
        """guidance_scale and strength, each a number or one per sample, as a
        (B,) scale vector and a (B, n_taps) matrix of control strengths
        (strength per tap, or the guess-mode decay): one engine signature
        serves uniform and mixed batches. A tuple of strengths
        (multi-ControlNet) gives a tuple of matrices, one a net."""
        if isinstance(strength, tuple):
            pairs = [self._per_sample_scales(batch, guidance_scale, s, guess_mode)
                     for s in strength]
            return pairs[0][0], tuple(cs for _, cs in pairs)
        gs = np.asarray(guidance_scale, np.float32).reshape(-1)
        if gs.size == 1:
            gs = np.full((batch,), gs[0], np.float32)
        st = np.asarray(strength, np.float32).reshape(-1)
        if st.size == 1:
            st = np.full((batch,), st[0], np.float32)
        if guess_mode:
            cs = np.stack([np.asarray(guess_mode_scales(float(s), self.n_taps))
                           for s in st]).astype(np.float32)
        else:
            cs = np.repeat(st[:, None], self.n_taps, axis=1)
        return (torch.as_tensor(gs, device=self.device),
                torch.as_tensor(cs, device=self.device))

    def _loop_inputs(self, num_steps, x_T, hint, ctx_cond, ctx_uncond,
                     guidance_scale, strength, eta, guess_mode, generator, noise,
                     init_latent, t_enc, renoise, encoder_cache_interval,
                     cfg_rescale, inpaint_latent, inpaint_mask, inpaint_noise,
                     seeds, sampler="ddim", tome_ratio=0.0):
        """Checks a loop call's arguments, draws every random number it needs
        (outside any graph) and returns (engine arguments, tensors to call it
        with). Draws come from `generator`, or with `seeds` row by row from
        each row's own generator, in the order: x_T or the re-noise, every
        step's noise (DDIM's eta noise, Euler-a's ancestral noise), every
        step's inpaint noise."""
        self._require_model()
        multi = isinstance(hint, tuple)
        self._check_hint_variant("multi" if multi else False)
        if multi:
            if len(hint) != self.n_nets:
                raise ValueError(f"multi-ControlNet: {len(hint)} hints for "
                                 f"{self.n_nets} ControlNets")
            if isinstance(strength, list):  # JSON surfaces give lists
                strength = tuple(strength)
            if not isinstance(strength, tuple):
                strength = (strength,) * self.n_nets  # shared by the nets
            if encoder_cache_interval > 1:
                raise ValueError("multi-ControlNet + encoder caching is unsupported")
        img2img = init_latent is not None
        if seeds is not None and x_T is not None:
            raise ValueError("seeds requires x_T=None (x_T is drawn from them)")
        if img2img:
            if x_T is not None:
                raise ValueError("img2img (init_latent) requires x_T=None")
            if t_enc is None or not 1 <= t_enc <= num_steps:
                raise ValueError(f"img2img needs 1 <= t_enc <= {num_steps}")
        inpaint = inpaint_latent is not None
        eta = self.check_sampler(sampler, eta, encoder_cache_interval, inpaint,
                                 img2img)
        if inpaint and inpaint_mask is None:
            raise ValueError("inpaint_latent requires inpaint_mask")
        if inpaint and encoder_cache_interval > 1:
            raise ValueError("inpainting + encoder caching is unsupported "
                             "(the cached-step features would mix blended and "
                             "unblended latents)")
        dev = self.device
        hints = [torch.as_tensor(hh, device=dev) for hh in (hint if multi else (hint,))]
        packed = not multi and hints[0].dim() == 3
        if packed and hints[0].dtype != torch.uint8:
            raise ValueError("rank-3 (packed) hint must be uint8")
        b, h, w = hints[0].shape[:3]
        w = w * 8 if packed else w
        f = self.cfg.vae.downsample_factor
        lat = (b, h // f, w // f, 4)
        steps = t_enc if img2img else num_steps
        sched = self._loop_schedule(steps, num_steps, eta, sampler)

        if seeds is not None:
            if len(seeds) != b:
                raise ValueError(f"{len(seeds)} seeds for a batch of {b}")
            rows = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]

            def draw():  # each row from its own generator: batch-independent
                return torch.stack([torch.randn(lat[1:], generator=g, device=dev)
                                    for g in rows])
        else:
            def draw():
                if generator is None:
                    raise ValueError("this call draws random numbers: pass "
                                     "generator= or seeds=")
                return torch.randn(lat, generator=generator, device=dev)

        def per_step(given, wanted):
            """(steps, B, h, w, 4) fp32: `given` where there is one, else a
            draw for each step that wants one."""
            if given is not None:
                return torch.stack([torch.as_tensor(n, device=dev).float()
                                    for n in given])
            return torch.stack([draw() if want else torch.zeros(lat, device=dev)
                                for want in wanted])

        if img2img:
            x = torch.as_tensor(init_latent, device=dev)
            extra = [draw() if renoise is None
                     else torch.as_tensor(renoise, device=dev).float()]
        else:
            x = draw() if x_T is None else torch.as_tensor(x_T, device=dev)
            extra = []
        noisy = _noisy_steps(sampler, sched)
        if noisy.any():
            extra.insert(0, per_step(noise, noisy))
        if inpaint:
            extra += [torch.as_tensor(inpaint_latent, device=dev).to(self.dtype),
                      torch.as_tensor(inpaint_mask, device=dev).to(self.dtype),
                      per_step(inpaint_noise, [True] * steps)]
        gs, cs = self._per_sample_scales(b, guidance_scale, strength, guess_mode)
        if multi:  # uint8 maps normalised as the one-net variant does (JAX _norm_hint)
            hints = [(hh.float() / 255.0 if hh.dtype == torch.uint8 else hh).to(self.dtype)
                     for hh in hints]
            hint_u8 = "multi"
        else:
            hint_u8 = "packed" if packed else hints[0].dtype == torch.uint8
            if not hint_u8:
                hints = [hints[0].to(self.dtype)]
        args = [x.to(self.dtype), *hints,
                ctx_cond.to(dev, self.dtype), ctx_uncond.to(dev, self.dtype),
                gs, *(cs if multi else (cs,))] + extra
        spec = dict(num_steps=steps, batch=b, h=h, w=w, guess_mode=guess_mode,
                    encoder_cache_interval=encoder_cache_interval,
                    ctx_len=ctx_cond.shape[1], hint_u8=hint_u8,
                    gen_xT="img2img" if img2img else False, inpaint=inpaint,
                    cfg_rescale=cfg_rescale, eta=eta, schedule_steps=num_steps,
                    sampler=sampler, tome_ratio=tome_ratio)
        return spec, args

    def sample(self, num_steps: int, x_T: Optional[torch.Tensor],
               hint: torch.Tensor, ctx_cond: torch.Tensor,
               ctx_uncond: torch.Tensor, guidance_scale=9.0, strength=1.0,
               eta: float = 0.0, guess_mode: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               init_latent: Optional[torch.Tensor] = None,
               t_enc: Optional[int] = None,
               renoise: Optional[torch.Tensor] = None,
               encoder_cache_interval: int = 1, cfg_rescale: float = 0.0,
               inpaint_latent: Optional[torch.Tensor] = None,
               inpaint_mask: Optional[torch.Tensor] = None,
               inpaint_noise: Optional[Sequence[torch.Tensor]] = None,
               seeds: Optional[Sequence[int]] = None, sampler: str = "ddim",
               tome_ratio: float = 0.0) -> torch.Tensor:
        """The sampler's latents (fp32 NHWC) through the sampler engine. x_T: NHWC
        latents, or None to draw them (`seeds`: one per row, each row from its
        own generator, so a row's draws do not depend on the batch it runs in;
        else `generator`); hint: uint8 NHWC pixels (normalised in the engine:
        /255 in fp32, then the compute dtype), a rank-3 uint8 (B, H, W/8)
        bit-packed binary map (np.packbits order; unpacked in the engine), or
        floats in [0, 1]; on a multi-ControlNet runtime a tuple of one hint a
        net (uint8 maps normalised before the call, floats cast).
        guidance_scale, strength: a number or one per sample; with several
        ControlNets a tuple of one such a net, or one for all. With eta > 0
        (DDIM) or sampler "euler-a[-uniform]" the step noise is `noise` (one
        NHWC tensor per step) or drawn.

        sampler: "ddim", "plms" (eta 0 only), "dpmpp[-karras]",
        "unipc[-karras]", "euler[-uniform]", "euler-a[-uniform]" or
        "heun[-uniform]"; eta is read by DDIM only. tome_ratio > 0: token
        merging in both nets (ops/tome.py).

        init_latent + t_enc (img2img semantics, the hires refine): x_T must
        be None; the init latent, rounded to the compute dtype, is re-noised
        to the entry step of the num_steps schedule (`renoise`, NHWC, or
        drawn) and only the last t_enc steps run.

        encoder_cache_interval, cfg_rescale, inpaint_latent (B, h, w, 4) +
        inpaint_mask (B, h, w, 1; 1 = generate) + inpaint_noise: see
        pipeline/ddim.py:ddim_sample (DDIM only)."""
        spec, args = self._loop_inputs(
            num_steps, x_T, hint, ctx_cond, ctx_uncond, guidance_scale, strength,
            eta, guess_mode, generator, noise, init_latent, t_enc, renoise,
            encoder_cache_interval, cfg_rescale, inpaint_latent, inpaint_mask,
            inpaint_noise, seeds, sampler, tome_ratio)
        z = self._out(self.sampler_engine(**spec)(*args))
        self.last_latents = z
        return z

    def sample_decode(self, num_steps: int, x_T, hint, ctx_cond, ctx_uncond,
                      guidance_scale=9.0, strength=1.0, eta: float = 0.0,
                      guess_mode: bool = False, generator=None, noise=None,
                      init_latent=None, t_enc=None, renoise=None,
                      encoder_cache_interval: int = 1, cfg_rescale: float = 0.0,
                      inpaint_latent=None, inpaint_mask=None, inpaint_noise=None,
                      seeds=None, sampler: str = "ddim",
                      tome_ratio: float = 0.0) -> torch.Tensor:
        """The sampler + VAE decode + uint8 denormalisation through the fused
        engine: uint8 (B, H, W, 3) on the device; the latents are left in
        `last_latents`. Arguments as `sample`."""
        spec, args = self._loop_inputs(
            num_steps, x_T, hint, ctx_cond, ctx_uncond, guidance_scale, strength,
            eta, guess_mode, generator, noise, init_latent, t_enc, renoise,
            encoder_cache_interval, cfg_rescale, inpaint_latent, inpaint_mask,
            inpaint_noise, seeds, sampler, tome_ratio)
        img, z = self._out(self.sample_decode_engine(**spec)(*args))
        self.last_latents = z
        return img

    def decode_latent_device(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) -> uint8 NHWC pixels on the device."""
        z = torch.as_tensor(z, device=self.device).to(self.dtype)
        b, lh, lw, _ = z.shape
        f = self.cfg.vae.downsample_factor
        return self._out(self.decoder_engine(b, lh * f, lw * f)(z))

    def decode_latent(self, z: torch.Tensor) -> np.ndarray:
        return self.decode_latent_device(z).cpu().numpy()

    def engine_census(self) -> Dict[str, Dict[str, Any]]:
        """{engine name: get_engine_infor()} of every engine built (a name
        that recurs, as under other kernel flags, gets "#2", "#3", ...)."""
        out: Dict[str, Dict[str, Any]] = {}
        for eng in self._engines.values():
            name, i = eng.name, 1
            while name in out:
                i += 1
                name = f"{eng.name}#{i}"
            out[name] = eng.get_engine_infor()
        return out

    def report(self) -> str:
        """Engine census: one line an engine, with its capture time, graph
        nodes and the bytes of its graph's memory pool."""
        lines = []
        for _, eng in sorted(self._engines.items(), key=str):
            info = eng.get_engine_infor()
            if info["compiled"]:
                lines.append(
                    f"{eng.name}: capture {info['compile_seconds']:.1f}s, "
                    f"{info['device_ops']} device ops, pool "
                    f"{info['memory']['pool_bytes'] / 1e6:.0f} MB")
            else:
                lines.append(f"{eng.name}: eager")
        return "\n".join(lines)

    def warmup(self, resolution: int = 256, num_steps: int = 1,
               batch: int = 1):
        """Start-up self-test: build and run every engine once at one shape
        (CLIP, the loop, the decoder, loop + decode fused) on a uint8 hint (a
        multi-ControlNet runtime: one float hint a net), and hold the fused engine's image to the granular path's (`sample`
        then `decode_latent`) on the same x_T: they must be equal in bytes.
        On a capturing runtime an engine that is not a captured graph fails
        the warm-up. Returns the image shape."""
        if resolution % 64:
            raise ValueError("resolutions are multiples of 64 (resize_image)")
        f = self.cfg.vae.downsample_factor
        ids = np.zeros((batch, self.cfg.clip.max_length), np.int64)
        ctx = self.encode_prompt(ids)
        x_T = torch.randn((batch, resolution // f, resolution // f, 4),
                          generator=torch.Generator().manual_seed(0)).to(self.device)
        hint = self._zeros((batch, resolution, resolution, 3), torch.uint8)
        if self.multi:
            hint = (hint.to(self.dtype),) * self.n_nets
        img = self.decode_latent(self.sample(num_steps, x_T, hint, ctx, ctx))
        fused = self.sample_decode(num_steps, x_T, hint, ctx, ctx).cpu().numpy()
        if fused.shape != img.shape or not np.array_equal(fused, img):
            raise RuntimeError(
                f"warmup self-test: the fused engine's image {fused.shape} "
                f"differs from the granular path's {img.shape} in "
                f"{int((fused != img).sum()) if fused.shape == img.shape else 'shape'}"
                " values")
        if self.capturing:
            eager = [e.name for k, e in self._engines.items()
                     if k[-2] and not e.compiled]  # k[-2]: built while capturing
            if eager:
                raise RuntimeError(f"warmup: engines were not captured: {eager}")
        return tuple(img.shape)

    def release(self) -> None:
        """Drop the engines (their graphs and memory pools) and the weights,
        and return the device memory they held."""
        self._engines.clear()
        self.model = None
        self.last_latents = None
        if self.device.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
