"""The port's utilities (stablediffusioneo_tpu_torch/utils/) against the JAX
package's: nan_report's paths and order equal to jax.tree_util.keystr's on
equal dict trees, assert_finite's message, log_txt_as_img byte for byte,
count_params, seed_everything, the exports."""

import random

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu import utils as jax_utils
from stablediffusioneo_tpu.utils import debug as jax_debug
from stablediffusioneo_tpu.utils import misc as jax_misc
from stablediffusioneo_tpu_torch import utils
from stablediffusioneo_tpu_torch.utils import debug, misc


def _tree(bad=()):
    """A nested dict tree (lists, tuples, bool / int / float leaves, Python
    numbers, None) as numpy arrays, with NaN / inf at the named leaves."""
    rng = np.random.default_rng(0)

    def leaf(name, shape=(3, 2), dtype=np.float32):
        a = rng.standard_normal(shape).astype(dtype)
        if name in bad:
            a.flat[-1] = np.nan if "nan" in name else np.inf
        return a

    return {"unet": {"w": leaf("w nan"), "blocks": [leaf("b0 inf"), {"g": leaf("g"),
                                                                     "h": leaf("h nan")}]},
            "vae": (leaf("v0"), leaf("v1 inf", (4,), np.float16)),
            "mask": np.array([True, False]), "step": np.arange(3), "lr": 1e-4,
            "none": None, "a": {"z": leaf("z nan", ())}}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


@pytest.mark.parametrize("bad", [(), ("w nan",), ("w nan", "b0 inf", "h nan", "v1 inf", "z nan"),
                                 ("g", "v0")], ids=["finite", "one", "all", "none named"])
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_nan_report_paths_equal_jax_keystr(bad, as_torch):
    tree = _tree(bad)
    want = jax_debug.nan_report(tree)
    got = debug.nan_report(_torch(tree) if as_torch else tree)
    assert got == want
    if len(bad) == 5:
        assert len(got) == 5


@pytest.mark.parametrize("max_entries", [1, 2, 10])
def test_nan_report_max_entries(max_entries):
    tree = _tree(("w nan", "b0 inf", "h nan", "v1 inf", "z nan"))
    assert debug.nan_report(_torch(tree), max_entries) == \
        jax_debug.nan_report(tree, max_entries)


def test_nan_report_on_a_module():
    net = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.BatchNorm1d(3))
    assert debug.nan_report(net) == []
    with torch.no_grad():
        net[0].bias[1] = float("nan")
    assert debug.nan_report({"net": net}) == ["['net']['0.bias']"]
    bf16 = net.to(torch.bfloat16)
    assert debug.nan_report(bf16) == ["['0.bias']"]


def test_assert_finite_message_equals_jax():
    tree = _tree(("h nan",))
    with pytest.raises(AssertionError) as port:
        debug.assert_finite(_torch(tree), "params")
    with pytest.raises(AssertionError) as ref:
        jax_debug.assert_finite(tree, "params")
    assert str(port.value) == str(ref.value)
    debug.assert_finite(_torch(_tree()), "params")


def test_enable_debug_nans_is_anomaly_mode():
    try:
        debug.enable_debug_nans(True)
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("wh,captions", [
    ((256, 64), ["a bird on a branch", ""]),
    ((96, 48), ["a long caption that wraps over more lines than fit in the canvas"]),
    ((12, 12), ["x"]),
    ((320, 200), ["line one", "the second caption, with punctuation: (1.3)!", "3"])])
def test_log_txt_as_img_is_byte_equal(wh, captions):
    got = misc.log_txt_as_img(wh, captions)
    want = jax_misc.log_txt_as_img(wh, captions)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_count_params_equals_jax():
    tree = {"a": np.zeros((3, 4)), "b": [np.zeros(5), {"c": np.zeros((2, 2, 2))}]}
    assert utils.count_params(_torch(tree)) == jax_misc.count_params(tree) == 25


def test_seed_everything_seeds_python_numpy_and_torch():
    g = misc.seed_everything(1234)
    assert isinstance(g, torch.Generator)
    draws = (random.random(), np.random.random(), torch.rand(1).item(),
             torch.rand(1, generator=g).item())
    misc.seed_everything(1234)
    assert (random.random(), np.random.random(), torch.rand(1).item()) == draws[:3]
    assert torch.rand(1, generator=torch.Generator().manual_seed(1234)).item() == draws[3]
    jax_misc.seed_everything(1234)
    assert np.random.random() == draws[1]
    misc.seed_everything(2**32 + 5)  # numpy takes the seed mod 2**32, as the JAX package's


def test_exports_are_the_jax_packages():
    assert utils.__all__ == jax_utils.__all__
    assert all(callable(getattr(utils, name)) for name in utils.__all__)
