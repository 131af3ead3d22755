"""The port's DPM-Solver++(2M) and UniPC loops (pipeline/dpm_solver.py,
pipeline/unipc.py) against the JAX scans `dpmpp_sample_scan` and
`unipc_sample_scan`, fp32 on the CPU at tiny_pipeline() size, on the same
weights, x_T, hint and contexts: latents within 1e-3, as the DDIM loop
tests. Each scan is jitted once per parameterization; both spacings run
through that one program, since the schedule is an argument. The schedule
itself is held to the JAX package's exactly."""

import numpy as np
import pytest

from stablediffusioneo_tpu.pipeline import dpm_solver as jax_dpm
from stablediffusioneo_tpu.pipeline.unipc import unipc_sample_scan
from stablediffusioneo_tpu_torch.pipeline.dpm_solver import dpmpp_sample, dpmpp_schedule
from stablediffusioneo_tpu_torch.pipeline.unipc import unipc_sample

from torch_port_util import (
    jitted_scan,
    port_model,
    run_sampler_pair,
    schedules,
    tiny_params,
)

STEPS = 3


@pytest.fixture(scope="module")
def nets():
    params = tiny_params()
    return params, port_model(params)


@pytest.mark.parametrize("spacing", ["uniform", "karras"])
@pytest.mark.parametrize("n", [1, 2, 7, 20])
def test_dpmpp_schedule_equals_the_jax_packages(spacing, n):
    port, ref = schedules()
    out, want = dpmpp_schedule(port, n, spacing), jax_dpm.dpmpp_schedule(ref, n, spacing)
    assert out.keys() == want.keys()
    for k in want:
        assert out[k].dtype == want[k].dtype and np.array_equal(out[k], want[k]), k


def test_unknown_spacing_raises():
    with pytest.raises(ValueError, match="unknown dpmpp spacing"):
        dpmpp_schedule(schedules()[0], 3, "cosine")


@pytest.mark.parametrize("parameterization", ["eps", "v"])
@pytest.mark.parametrize("spacing", ["uniform", "karras"])
def test_dpmpp_loop_matches_jax(nets, spacing, parameterization):
    sched = dpmpp_schedule(schedules()[0], STEPS, spacing)
    out, ref = run_sampler_pair(*nets, jitted_scan(jax_dpm.dpmpp_sample_scan,
                                                   parameterization),
                                dpmpp_sample, sched, parameterization)
    assert np.abs(out - ref).max() <= 1e-3


@pytest.mark.parametrize("parameterization", ["eps", "v"])
@pytest.mark.parametrize("spacing", ["uniform", "karras"])
def test_unipc_loop_matches_jax(nets, spacing, parameterization):
    sched = dpmpp_schedule(schedules()[0], STEPS, spacing)
    out, ref = run_sampler_pair(*nets, jitted_scan(unipc_sample_scan, parameterization),
                                unipc_sample, sched, parameterization)
    assert np.abs(out - ref).max() <= 1e-3
    # the corrector changes the result: UniPC is not DPM++ on the same grid
    dpm, _ = run_sampler_pair(*nets, jitted_scan(jax_dpm.dpmpp_sample_scan,
                                                 parameterization),
                              dpmpp_sample, sched, parameterization)
    assert np.abs(out - dpm).max() > 1e-3


def test_single_step_unipc_is_a_predictor_step(nets):
    """N = 1: one evaluation and the order-1 predictor, as the JAX scan's
    n == 1 edge (no corrector)."""
    sched = dpmpp_schedule(schedules()[0], 1, "uniform")
    out, ref = run_sampler_pair(*nets, jitted_scan(unipc_sample_scan, "eps"),
                                unipc_sample, sched, "eps")
    assert np.abs(out - ref).max() <= 1e-3
