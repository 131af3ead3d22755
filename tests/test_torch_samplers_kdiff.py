"""The port's PLMS and k-diffusion loops (pipeline/plms.py,
pipeline/k_diffusion.py: Euler, Euler-a, Heun) against the JAX scans
`plms_sample_scan` and `kdiff_sample_scan`, fp32 on the CPU at
tiny_pipeline() size, on the same weights, x_T, hint and contexts: latents
within 1e-3, as the DDIM loop tests. Euler-a's step noise is the JAX scan's
own (`_step_noise` of its key), handed in. Each scan is jitted once per
sampler and parameterization; both spacings run through that one program.
PLMS takes 4 steps, so that its AB4 rung runs; the k-diffusion samplers 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.pipeline import k_diffusion as jax_kd
from stablediffusioneo_tpu.pipeline.ddim import _step_noise
from stablediffusioneo_tpu.pipeline.plms import plms_sample_scan
from stablediffusioneo_tpu_torch.pipeline.k_diffusion import (
    KDIFF_SAMPLERS,
    kdiff_sample,
    kdiff_schedule,
)
from stablediffusioneo_tpu_torch.pipeline.plms import plms_sample

from torch_port_util import (
    jitted_scan,
    port_model,
    run_sampler_pair,
    sampler_inputs,
    schedules,
    tiny_params,
)

STEPS = 3


@pytest.fixture(scope="module")
def nets():
    params = tiny_params()
    return params, port_model(params)


def test_the_sampler_names_are_the_jax_packages():
    assert KDIFF_SAMPLERS == jax_kd.KDIFF_SAMPLERS


@pytest.mark.parametrize("spacing", ["uniform", "karras"])
@pytest.mark.parametrize("n", [1, 2, 7, 20])
def test_kdiff_schedule_equals_the_jax_packages(spacing, n):
    port, ref = schedules()
    out, want = kdiff_schedule(port, n, spacing), jax_kd.kdiff_schedule(ref, n, spacing)
    assert out.keys() == want.keys()
    for k in want:
        assert out[k].dtype == want[k].dtype and np.array_equal(out[k], want[k]), k


@pytest.mark.parametrize("steps,parameterization", [(4, "eps"), (4, "v"), (1, "eps")])
def test_plms_loop_matches_jax(nets, steps, parameterization):
    """4 steps run every rung (priming, AB2, AB3, AB4); 1 step is the
    priming alone, whose second evaluation is at t = 0."""
    sched = schedules()[0].ddim(steps)
    out, ref = run_sampler_pair(*nets, jitted_scan(plms_sample_scan, parameterization),
                                plms_sample, sched, parameterization)
    assert np.abs(out - ref).max() <= 1e-3


@pytest.mark.parametrize("parameterization", ["eps", "v"])
@pytest.mark.parametrize("spacing", ["karras", "uniform"])
@pytest.mark.parametrize("sampler", KDIFF_SAMPLERS)
def test_kdiff_loop_matches_jax(nets, sampler, spacing, parameterization):
    sched = kdiff_schedule(schedules()[0], STEPS, spacing)
    key = jax.random.PRNGKey(11)
    shape = sampler_inputs()["x_T"].shape
    noise = torch.stack([torch.from_numpy(np.array(_step_noise(key, jnp.int32(i), shape)))
                         for i in range(STEPS)])
    out, ref = run_sampler_pair(
        *nets, jitted_scan(jax_kd.kdiff_sample_scan, parameterization, sampler=sampler),
        kdiff_sample, sched, parameterization, jax_rest=(key,), sampler=sampler,
        noise=noise)
    assert np.abs(out - ref).max() <= 1e-3
