"""Rank-side half of the port's parallel tests (test_torch_parallel.py,
test_torch_pipeline_pp.py, test_torch_mesh_sp.py).

`spawn(job, world, directory, **inputs)` runs `job(rank, **inputs)` in
`world` processes (torch.multiprocessing, spawn) joined by a gloo process
group over a FileStore under `directory`, so that concurrent test workers
never share a port; each rank runs torch with one thread and returns a
picklable result, and the parent gets every rank's. The jobs import the
port only (no JAX): the parent test computes the JAX package's references
and compares. Inputs and weights travel as numpy arrays and port state
dicts in files.
"""

import os
import pathlib
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(job, world: int, directory, **inputs):
    d = pathlib.Path(directory) / f"{job.__name__}-w{world}"
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    mp.spawn(_entry, args=(world, str(d), job), nprocs=world, join=True)
    return [torch.load(d / f"out.{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank, world, d, job):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
        out = job(rank, **inputs)
        torch.save(out, os.path.join(d, f"out.{rank}.pt"))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _t(a):
    return torch.from_numpy(np.array(a))


def tome_cfg(min_tokens=32):
    """The tiny configuration with ToMe merging from `min_tokens` tokens (the
    64 tokens of a 64x64 image's level 0 qualify)."""
    import dataclasses

    from stablediffusioneo_tpu_torch.config import tiny_pipeline

    cfg = tiny_pipeline()
    unet = dataclasses.replace(cfg.unet, tome_min_tokens=min_tokens)
    return dataclasses.replace(cfg, unet=unet,
                               controlnet=dataclasses.replace(cfg.controlnet, unet=unet))


def port_model(sd):
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM

    model = ControlLDM(tiny_pipeline())
    model.load_checkpoint(sd)
    return model.eval().requires_grad_(False)


def request(b=4, seed=0):
    """The tiny configuration's sampler request: x_T, a {0, 1} float hint,
    a uint8 one, contexts, CLIP ids, an init latent and an inpaint mask."""
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((2, b, 16, 64), dtype=np.float32)
    return {"x_T": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "hint": (rng.random((b, 64, 64, 3)) > 0.7).astype(np.float32),
            "hint_u8": ((rng.random((b, 64, 64, 3)) > 0.7) * 255).astype(np.uint8),
            "ctx_c": ctx[0], "ctx_u": ctx[1],
            "ids": rng.integers(0, 1000, (b, 16)),
            "lat": rng.standard_normal((b, 8, 8, 4), dtype=np.float32),
            "mask": (rng.random((b, 8, 8, 1)) > 0.5).astype(np.float32)}


def run_sampler(rt, x):
    """(latents, uint8 images, CLIP contexts) of the test's request."""
    z = rt.sample(2, _t(x["x_T"]), _t(x["hint"]), _t(x["ctx_c"]), _t(x["ctx_u"]),
                  guidance_scale=7.5, strength=0.8)
    return {"z": _np(z), "img": rt.decode_latent(z), "ctx": _np(rt.encode_prompt(x["ids"]))}


# ------------------------------------------------------- test_torch_parallel


def runtime_job(rank, sd, x, mesh_kw, lora=None):
    """A mesh runtime's sampler, decode and CLIP calls (and with a LoRA tree
    the inpaint and img2img engines, then the sampler after the merge); the
    TP specs it applied."""
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.parallel import make_mesh
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    mesh = make_mesh(**mesh_kw)
    rt = CNSDRuntime(port_model(sd), tiny_pipeline(), device="cpu", mesh=mesh)
    out = run_sampler(rt, x)
    attn = rt.model.unet.input_blocks[1][1].transformer_blocks[0].attn1
    out.update(axis_names=mesh.axis_names, specs=dict(rt.model.tp_specs),
               heads=attn.heads, wq=tuple(attn.to_q.weight.shape),
               engines={e.name: (e.dp is not None, e.sp is not None)
                        for e in rt._engines.values()})
    if lora is not None:
        out.update(extra_calls(rt, x, lora))
    return out


def extra_calls(rt, x, lora):
    """The inpaint and img2img engines (uint8 hint, the JAX draws handed in:
    the inpaint blend's per-step noise, img2img's re-noise) as latents and
    images, and the sampler's latents after `lora` (a tree of numpy
    factors) is merged into the UNet at scale 0.8."""
    ctx_c, ctx_u, hint = _t(x["ctx_c"]), _t(x["ctx_u"]), _t(x["hint_u8"])
    kw = dict(guidance_scale=7.5, strength=0.8)
    out = {}
    out["inpaint"] = _np(rt.sample_decode(
        2, _t(x["x_T"]), hint, ctx_c, ctx_u, inpaint_latent=_t(x["lat"]),
        inpaint_mask=_t(x["mask"]), inpaint_noise=[_t(n) for n in x["inpaint_noise"]], **kw))
    out["inpaint_z"] = _np(rt.last_latents)
    out["img2img"] = _np(rt.sample_decode(2, None, hint, ctx_c, ctx_u, init_latent=_t(x["lat"]),
                                          t_enc=1, renoise=_t(x["renoise"]), **kw))
    out["img2img_z"] = _np(rt.last_latents)
    rt.apply_lora(_tree(lora), scale=0.8, on="unet")
    out["lora"] = run_sampler(rt, x)["z"]
    return out


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def train_step_job(rank, nets, batch, t, noise, mesh_kw, fsdp):
    """One train_step of the mesh state (its draws handed in): the loss,
    the whole gradients and parameters after the step, and the shares of the
    large leaves and moments this rank holds."""
    import copy

    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.parallel import make_mesh, shard_params
    from stablediffusioneo_tpu_torch.parallel.mesh import FSDP_MIN_SIZE
    from stablediffusioneo_tpu_torch.training import loop, trainer

    cfg = tiny_pipeline()
    mesh = make_mesh(**mesh_kw)
    unet = shard_params(copy.deepcopy(nets["unet"]), mesh)
    if fsdp:
        unet = trainer.fsdp_frozen(unet, mesh)
    net = shard_params(copy.deepcopy(nets["controlnet"]), mesh)
    state, tx = trainer.create_train_state(net, 1e-3, mesh=mesh, fsdp=fsdp)
    sa, s1 = trainer.make_schedule_buffers(cfg, "cpu")
    state, loss = trainer.train_step(state, tx, unet, cfg, sa, s1,
                                     {k: _t(v) for k, v in batch.items()}, key=7,
                                     t=_t(t).long(), noise=_t(noise))
    names = list(state.params)
    grads = loop._unshard(state, [state.params[n].grad for n in names])
    params = loop._unshard(state, [state.params[n].detach() for n in names])
    big = [(state.params[n], nets["controlnet"].get_parameter(n)) for n in names
           if nets["controlnet"].get_parameter(n).numel() >= FSDP_MIN_SIZE]
    moments = [(tx.state[p]["exp_avg"], whole) for p, whole in big]
    share = (sum(p.numel() for p, _ in big) / sum(w.numel() for _, w in big),
             sum(m.numel() for m, _ in moments) / sum(w.numel() for _, w in moments))
    sharded = sorted(n for n, s in (state.fsdp_specs or {}).items() if "dp" in s)
    return {"loss": float(loss), "grads": dict(zip(names, map(_np, grads))),
            "params": dict(zip(names, map(_np, params))), "share": share,
            "fsdp_sharded": sharded, "tp_specs": dict(getattr(net, "tp_specs", {}))}


def train_loop_job(rank, nets, batches, kw, directory):
    """train() over the mesh of kw for len(batches) steps with a checkpoint
    at the end; the file's tensors."""
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.training.loop import _unshard, train

    ckpt = os.path.join(directory, "ckpt")
    state = train(tiny_pipeline(), nets["unet"], nets["controlnet"], iter(batches),
                  len(batches), learning_rate=1e-3, ema_decay=0.9, ckpt_dir=ckpt,
                  ckpt_every=len(batches), metrics_path=None, device="cpu", **kw)
    dist.barrier()
    saved = torch.load(os.path.join(ckpt, f"step_{len(batches):09d}.pt"), weights_only=True)
    names = list(state.params)
    ema = _unshard(state, [state.ema[n] for n in names])
    return {"params": {k: _np(v) for k, v in saved["params"].items()},
            "ema": dict(zip(names, map(_np, ema))), "names": names,
            "exp_avg": [_np(s["exp_avg"]) for _, s in sorted(saved["opt_state"]["state"].items())],
            "step": int(state.step), "mesh": state.mesh.axis_names}


def sdxl_job(rank, sd, x, mesh_kw):
    """The SDXL base's DDIM loop with its UNet tensor-parallel and the batch
    over dp; every rank gathers the whole batch."""
    from stablediffusioneo_tpu_torch.models import sdxl
    from stablediffusioneo_tpu_torch.models.unet import UNetModel
    from stablediffusioneo_tpu_torch.ops.schedule import DiffusionSchedule
    from stablediffusioneo_tpu_torch.parallel import data_sharding, make_mesh, shard_params

    mesh = make_mesh(**mesh_kw)
    unet = UNetModel(sdxl.tiny_sdxl().unet)
    unet.load_state_dict(sd)
    unet.eval().requires_grad_(False)
    shard_params(unet, mesh)
    names = ("x_T", "ctx_c", "ctx_u", "y_c", "y_u")
    local = [data_sharding(mesh, x[k].ndim).local(_t(x[k])) for k in names]
    with torch.no_grad():
        out = sdxl.sdxl_txt2img(unet, DiffusionSchedule().ddim(x["steps"]), *local,
                                x["scale"])
    return {"z": _np(data_sharding(mesh, 4).gather(out)),
            "specs": sorted(set(unet.tp_specs.values()), key=str)}


def serve_job(rank, sd, requests, mesh_kw):
    """A served batch on a mesh runtime: rank 0 serves, the others follow."""
    from stablediffusioneo_tpu_torch.parallel import make_mesh
    from stablediffusioneo_tpu_torch.serving.server import DiffusionServer

    srv = DiffusionServer(tiny_pipeline_obj(sd, make_mesh(**mesh_kw)),
                          batch_buckets=(1, 2), max_wait_ms=5000)
    if rank:
        return {"cuts": srv.follow()}
    srv.warmup(resolutions=(64,), steps=2)
    srv.start()
    futs = [srv.submit(r) for r in requests]
    images = [f.result(timeout=600)[1] for f in futs]
    srv.stop()
    return {"images": images, "hist": dict(srv.stats.batch_hist)}


def tiny_pipeline_obj(sd, mesh=None):
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.tokenizer import toy_tokenizer
    from stablediffusioneo_tpu_torch.pipeline.canny2image import Canny2ImagePipeline

    cfg = tiny_pipeline()
    return Canny2ImagePipeline(port_model(sd), toy_tokenizer(cfg.clip.vocab_size,
                                                             cfg.clip.max_length),
                               cfg, device="cpu", mesh=mesh)


# --------------------------------------------------- test_torch_pipeline_pp


def toy_fn(p, x, scale):
    return torch.tanh(x @ p["w"] + p["b"]) * scale + x


def extra_fn(p, x, e):
    return torch.tanh(x @ p["w"]) + e


def _caught(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def pipeline_job(rank, layers, x, scale, ex_layers, ex_x, ex_e, clip_sd, clip_ids,
                 t5_sd, t5_ids, t5_mask):
    """Every pipeline case of the world's meshes (2 or 4 ranks)."""
    from stablediffusioneo_tpu_torch.parallel import (
        make_mesh,
        pipeline_apply,
        pp_shard_params,
        stack_layer_params,
    )

    out = {}
    stacked = stack_layer_params([{k: _t(v) for k, v in p.items()} for p in layers])
    xs = _t(x)
    if dist.get_world_size() == 4:
        for name, kw in (("pp4", dict(pp=4, dp=1)), ("pp2dp2", dict(pp=2, dp=2))):
            mesh = make_mesh(**kw)
            out[name + "_axes"] = mesh.axis_names
            out[name] = _np(pipeline_apply(toy_fn, stacked, xs, mesh, extra=(scale,)))
            out[name + "_grad"] = _grads(stacked, xs, scale, mesh, remat=False)
        mesh = make_mesh(pp=4, dp=1)
        ex = stack_layer_params([{"w": _t(p["w"])} for p in ex_layers])
        out["batched_extra"] = _np(pipeline_apply(extra_fn, ex, _t(ex_x), mesh,
                                                  batched_extra=(_t(ex_e),), microbatches=2))
        six = {k: v[:6] for k, v in stacked.items()}
        out["tile_layers"] = _caught(lambda: pipeline_apply(toy_fn, six, xs, mesh,
                                                            extra=(scale,)))
        return out
    mesh = make_mesh(pp=2, dp=1)
    for m in (1, 2, 4):
        out[f"mb{m}"] = _np(pipeline_apply(toy_fn, stacked, xs, mesh, extra=(scale,),
                                           microbatches=m))
    out["tile_batch"] = _caught(lambda: pipeline_apply(toy_fn, stacked, xs, mesh,
                                                       extra=(scale,), microbatches=3))
    y, pen = pipeline_apply(toy_fn, stacked, xs, mesh, extra=(scale,),
                            capture_last_input=True)
    out["capture"] = (_np(y), _np(pen))
    stage = pp_shard_params(stacked, mesh)
    out["stage"] = (stage.n_layers, stage.stage, tuple(stage["w"].shape))
    out["prestaged"] = _np(pipeline_apply(toy_fn, stage, xs, mesh, extra=(scale,)))
    for remat in (False, True):
        out[f"grad_remat{int(remat)}"] = _grads(stacked, xs, scale, mesh, remat)
    out.update(tower_cases(mesh, clip_sd, clip_ids, t5_sd, t5_ids, t5_mask))
    single = make_mesh(dp=2, tp=1)
    out["single_axes"] = single.axis_names
    out["single"] = _np(pipeline_apply(toy_fn, stacked, xs, single, extra=(scale,)))
    return out


def _grads(stacked, x, scale, mesh, remat):
    """{name: (L, ...) gradient} of sum(pipeline output)^2 / 2 w.r.t. the
    stacked layers: this rank's stage rows (zeros elsewhere)."""
    from stablediffusioneo_tpu_torch.parallel import pipeline_apply

    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in stacked.items()}
    y = pipeline_apply(toy_fn, leaves, x, mesh, extra=(scale,), remat=remat,
                       microbatches=2)
    (y.square().sum() / 2).backward()
    return {k: _np(v.grad) for k, v in leaves.items()}


def tower_cases(mesh, clip_sd, clip_ids, t5_sd, t5_ids, t5_mask):
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models import t5 as pt5
    from stablediffusioneo_tpu_torch.models.clip import CLIPTextModel, clip_text_apply_pp
    from stablediffusioneo_tpu_torch.parallel import pp_shard_params, stack_layer_params

    clip = CLIPTextModel(tiny_pipeline().clip)
    clip.load_state_dict(clip_sd)
    clip.eval().requires_grad_(False)
    ids = _t(clip_ids).long()
    out = {f"clip_{layer}": _np(clip_text_apply_pp(clip, ids, mesh, layer=layer))
           for layer in ("last", "penultimate", "penultimate_raw")}
    stage = pp_shard_params(stack_layer_params(clip.blocks), mesh)
    out["clip_prestacked"] = _np(clip_text_apply_pp(clip, ids, mesh, stacked=stage))
    t5 = pt5.convert_t5(t5_sd, pt5.tiny_t5(), device="cpu")
    tids = _t(t5_ids).long()
    out["t5"] = _np(pt5.t5_encode_pp(t5, tids, mesh))
    out["t5_mask"] = _np(pt5.t5_encode_pp(t5, tids, mesh, mask=_t(t5_mask), microbatches=2))
    return out


# ------------------------------------------------------ test_torch_mesh_sp


def mesh_job(rank, sd, x):
    """The axis names, shapes and latent specs of the meshes the JAX tests
    build; the sampler request on a dp=2 x sp=2 runtime."""
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.parallel import latent_sharding, make_mesh
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    out = {}
    cases = {"dp2tp2": dict(dp=2, tp=2), "sp2": dict(dp=2, sp=2),
             "pp2": dict(pp=2, dp=2), "inferred": dict(tp=1, sp=2),
             "sp1": dict(dp=4, tp=1, sp=1)}
    for name, kw in cases.items():
        mesh = make_mesh(**kw)
        out[name] = (mesh.axis_names, tuple(mesh.shape.values()),
                     latent_sharding(mesh, 4).spec, latent_sharding(mesh, 1).spec)
    rt = CNSDRuntime(port_model(sd), tiny_pipeline(), device="cpu",
                     mesh=make_mesh(dp=2, sp=2))
    out["request"] = run_sampler(rt, x)
    out["engines"] = {e.name: (e.dp is not None, e.sp is not None)
                      for e in rt._engines.values()}
    return out


def sp_job(rank, sd, x, eval_x, attn, mesh_kw):
    """Row-parallel (sp) cases: one ControlNet + UNet evaluation and the VAE
    on this rank's rows, the mesh runtime's sampler and decode, and the
    attention sites on this rank's tokens."""
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.controlnet import controlled_unet_apply
    from stablediffusioneo_tpu_torch.models.vae import vae_decode, vae_encode
    from stablediffusioneo_tpu_torch.ops import dispatch
    from stablediffusioneo_tpu_torch.ops.attention import multi_head_attention
    from stablediffusioneo_tpu_torch.parallel import latent_sharding, make_mesh
    from stablediffusioneo_tpu_torch.parallel.mesh import spatial, spatial_modules
    from stablediffusioneo_tpu_torch.runtime.engine import CNSDRuntime

    mesh = make_mesh(**mesh_kw)
    sp = mesh.axis("sp")
    rows = latent_sharding(mesh, 4)
    model = port_model(sd)
    spatial_modules(model)
    out = {}

    def evaluation():
        eps = controlled_unet_apply(model.unet, model.control_model, rows.local(_t(eval_x["x"])),
                                    rows.local(_t(eval_x["hint"])), _t(eval_x["t"]),
                                    _t(eval_x["ctx"]))
        return _np(rows.gather(eps))

    with torch.no_grad(), spatial(sp):
        out["eps"] = evaluation()
        # the fused-norm configuration: GroupNorm through the stats and
        # apply entries with the partial sums all-reduced over sp (on the
        # CPU their plain versions), LayerNorm on a rank's tokens
        flags = dispatch.kernel_flags()
        dispatch.set_kernels(groupnorm=True, layernorm=True)
        try:
            out["eps_fused"] = evaluation()
        finally:
            dispatch.set_kernels(**dict(flags))
        out["decode"] = _np(rows.gather(vae_decode(model.first_stage_model,
                                                   rows.local(_t(eval_x["z"])))))
        enc = vae_encode(model.first_stage_model, rows.local(_t(eval_x["img"]))).mode()
        out["encode"] = _np(rows.gather(enc))
        for name, a in attn.items():
            xs = rows.local(_t(a["x"])[:, :, None, :]).squeeze(2) if a["split"] else _t(a["x"])
            y = multi_head_attention(xs, None if a["ctx"] is None else _t(a["ctx"]),
                                     *(_t(a[k]) for k in ("wq", "wk", "wv", "wo", "bo")),
                                     a["heads"])
            out["attn_" + name] = _np(rows.gather(y[:, :, None, :]).squeeze(2)
                                      if a["split"] else y)
    rt = CNSDRuntime(port_model(sd), tome_cfg(), device="cpu", mesh=mesh)
    out.update(run_sampler(rt, x))
    z = rt.sample(2, _t(x["x_T6"]), _t(x["hint6"]), _t(x["ctx_c"][:1]), _t(x["ctx_u"][:1]))
    out["z6"] = _np(z)
    out["engines"] = {e.name: (e.dp is not None, e.sp is not None)
                      for e in rt._engines.values()}
    out["rescale"] = _np(rt.sample(2, _t(x["x_T"]), _t(x["hint"]), _t(x["ctx_c"]),
                                   _t(x["ctx_u"]), cfg_rescale=0.7))
    out["tome"] = _np(rt.sample(2, _t(x["x_T"]), _t(x["hint"]), _t(x["ctx_c"]),
                                _t(x["ctx_u"]), tome_ratio=0.5))
    out["process"] = run_process(tiny_pipeline_obj(sd, mesh), x)
    return out


def run_process(pipe, x):
    """process() of the fixture square, 2 samples, 2 steps, x_T handed in."""
    src = np.zeros((64, 64, 3), np.uint8)
    src[16:48, 16:48] = 220
    res = pipe.process(src, "a test", "", "", num_samples=2, image_resolution=64,
                       ddim_steps=2, scale=7.5, seed=77, x_T=x["x_T"][:2])
    return np.stack(res[1:])


def multi_job(rank, jobs):
    """Several jobs in one world, in order: {name: (job name, inputs)}."""
    return {name: globals()[fn](rank, **kw) for name, (fn, kw) in jobs.items()}
