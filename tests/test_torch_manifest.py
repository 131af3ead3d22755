"""The port's weights manifest (stablediffusioneo_tpu_torch/checkpoint/
manifest.py) against the JAX package's on the same files: equal reports
(exact dict equality), equal ManifestError text, equal pinned manifests (the
written JSON byte for byte), over the JAX test's cases (tests/
test_manifest.py): exact universe, renamed file, wrong family, shape
mismatch, pin then tamper, pin refused, vocab / merges format; and a
.safetensors artifact, which the port reads with its own reader (I64 rows
included) and the JAX package with the safetensors package."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.checkpoint import manifest as jax_mf
from stablediffusioneo_tpu_torch.checkpoint import manifest as mf
from stablediffusioneo_tpu_torch.checkpoint.torch_reader import write_safetensors


def _outcome(fn, *args, **kw):
    """("ok", report) or ("error", message) of one call."""
    try:
        return "ok", fn(*args, **kw)
    except mf.ManifestError as e:
        return "error", str(e)
    except jax_mf.ManifestError as e:
        return "error", str(e)


def _both_verify(path, **kw):
    port, ref = _outcome(mf.verify_file, path, **kw), _outcome(jax_mf.verify_file, path, **kw)
    assert port == ref
    return port


def _zeros(universe):
    return {k: torch.zeros([int(d) for d in shape.split("x")] or [])
            for k, shape in mf.load_universe(universe).items()}


def test_manifest_is_the_port_own_file():
    """The packaged manifest resolves inside the port's package and loads to
    the JAX package's content."""
    port_dir = os.path.dirname(os.path.abspath(mf.__file__))
    assert os.path.dirname(mf.default_manifest_path()) == port_dir
    assert mf.default_manifest_path() != jax_mf.default_manifest_path()
    assert mf.load_manifest() == jax_mf.load_manifest()


def test_universes_load_and_digests_match():
    man = mf.load_manifest()
    for name, e in man["artifacts"].items():
        if e.get("universe"):
            uni = mf.load_universe(e["universe"])
            assert uni == jax_mf.load_universe(e["universe"])
            assert len(uni) == e["key_count"], name
            assert mf.key_universe_digest(uni) == e["key_universe_sha256"], name
            assert mf.key_universe_digest(uni) == jax_mf.key_universe_digest(uni)


def test_exact_universe_verifies_equally(tmp_path):
    p = tmp_path / "ControlNetHED.pth"
    torch.save(_zeros("hed"), str(p))
    kind, rep = _both_verify(str(p))
    assert kind == "ok" and rep["ok"] and rep["key_count"] == 37 and rep["sha256"] is None


@pytest.mark.parametrize("case", ["renamed", "wrong family", "shape mismatch",
                                  "extra key", "unknown name"])
def test_rejections_name_the_same_mismatch(tmp_path, case):
    kw = {}
    if case == "renamed":
        p = tmp_path / "mystery_weights.pth"
        torch.save({"w": torch.zeros(3)}, str(p))
        match = "renamed"
    elif case == "wrong family":
        p = tmp_path / "ControlNetHED.pth"
        torch.save({"not_hed.weight": torch.zeros(4, 4)}, str(p))
        match = "required keys missing"
    elif case == "shape mismatch":
        sd = _zeros("hed")
        sd[sorted(sd)[0]] = torch.zeros(7, 7)
        p = tmp_path / "ControlNetHED.pth"
        torch.save(sd, str(p))
        match = "shape mismatch"
    elif case == "extra key":
        sd = _zeros("hed")
        sd["stray.weight"] = torch.zeros(2)
        p = tmp_path / "ControlNetHED.pth"
        torch.save(sd, str(p))
        match = "unexpected keys"
    else:
        p = tmp_path / "ControlNetHED.pth"
        torch.save(_zeros("hed"), str(p))
        kw = {"name": "no_such_artifact"}
        match = "unknown artifact name"
    kind, msg = _both_verify(str(p), **kw)
    assert kind == "error" and match in msg


def test_known_unused_extras_are_allowed_equally(tmp_path):
    """control_sd15_canny's allowed_extra patterns (the DDPM buffers) hold
    in both packages: the universe's shapes, without their tensors' bytes,
    are checked through a file holding only a few keys plus the buffers,
    which both reject for the same missing keys."""
    uni = mf.load_universe("control_sd15_canny")
    keep = sorted(uni)[:5]
    sd = {k: torch.zeros([int(d) for d in uni[k].split("x")] or []) for k in keep}
    sd["betas"] = torch.zeros(1000)
    sd["model_ema.decay"] = torch.zeros(())
    p = tmp_path / "control_sd15_canny.pth"
    torch.save(sd, str(p))
    kind, msg = _both_verify(str(p))
    assert kind == "error" and "required keys missing" in msg and "unexpected" not in msg


def test_pin_then_tamper_gives_equal_manifests_and_errors(tmp_path):
    p = tmp_path / "ControlNetHED.pth"
    torch.save(_zeros("hed"), str(p))
    local_port, local_jax = tmp_path / "port.json", tmp_path / "jax.json"
    shutil.copy(mf.default_manifest_path(), local_port)
    shutil.copy(jax_mf.default_manifest_path(), local_jax)
    before = (open(mf.default_manifest_path(), "rb").read(),
              open(jax_mf.default_manifest_path(), "rb").read())
    e_port = mf.pin_file(str(p), manifest_path=str(local_port))
    e_jax = jax_mf.pin_file(str(p), manifest_path=str(local_jax))
    assert e_port == e_jax and e_port["size_bytes"] == os.path.getsize(p)
    assert local_port.read_bytes() == local_jax.read_bytes()
    # neither packaged manifest was written
    assert (open(mf.default_manifest_path(), "rb").read(),
            open(jax_mf.default_manifest_path(), "rb").read()) == before

    port = _outcome(mf.verify_file, str(p), manifest_path=str(local_port))
    ref = _outcome(jax_mf.verify_file, str(p), manifest_path=str(local_jax))
    assert port == ref and port[0] == "ok" and port[1]["sha256"] == e_port["sha256"]

    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))
    port = _outcome(mf.verify_file, str(p), manifest_path=str(local_port))
    ref = _outcome(jax_mf.verify_file, str(p), manifest_path=str(local_jax))
    assert port == ref and port[0] == "error" and "sha256" in port[1]


def test_pin_refuses_wrong_structure_equally(tmp_path):
    p = tmp_path / "ControlNetHED.pth"
    torch.save({"junk": torch.zeros(2)}, str(p))
    local = tmp_path / "manifest.json"
    local.write_text(json.dumps(mf.load_manifest()))
    port = _outcome(mf.pin_file, str(p), manifest_path=str(local))
    ref = _outcome(jax_mf.pin_file, str(p), manifest_path=str(local))
    assert port == ref and port[0] == "error" and "refusing to pin" in port[1]
    assert json.loads(local.read_text())["artifacts"]["hed"]["sha256"] is None


@pytest.mark.parametrize("good", [True, False])
def test_vocab_format_checks_equally(tmp_path, good):
    v = tmp_path / "vocab.json"
    v.write_text(json.dumps({f"tok{i}": i for i in range(49408)} if good else {"a": 0}))
    kind, out = _both_verify(str(v))
    assert (kind == "ok") == good
    if not good:
        assert "49408" in out


@pytest.mark.parametrize("text", ["#version: 0.2\n" + "\n".join(f"a{i} b{i}" for i in range(48100)),
                                  "a b\nc d\n", "#version: 0.2\na b\n"],
                         ids=["good", "no header", "short"])
def test_merges_format_checks_equally(tmp_path, text):
    m = tmp_path / "merges.txt"
    m.write_text(text)
    kind, _ = _both_verify(str(m))
    assert (kind == "ok") == text.startswith("#version: 0.2\na0")


def test_safetensors_artifact_read_by_each_package_reader(tmp_path):
    """sd_xl_base_1.0.safetensors written by the port's writer, holding a
    part of the SDXL universe (its I64 position_ids row among it) and a
    stray key: the same rejection text from both packages."""
    uni = mf.load_universe("sdxl_base")
    keys = [k for k in sorted(uni) if k.endswith("position_ids")] + sorted(uni)[:6]
    sd = {}
    for k in keys:
        shape = tuple(int(d) for d in uni[k].split("x") if d)
        sd[k] = (np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
                 if k.endswith("position_ids") else np.zeros(shape, np.float32))
    sd["stray.weight"] = np.zeros(3, np.float32)
    p = tmp_path / "sd_xl_base_1.0.safetensors"
    write_safetensors(sd, str(p))
    kind, msg = _both_verify(str(p))
    assert kind == "error" and "required keys missing" in msg and "stray.weight" in msg


def test_sha256_and_digest_helpers_agree(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    assert mf.sha256_file(str(p)) == jax_mf.sha256_file(str(p))
    assert mf.sha256_file(str(p), chunk=4097) == jax_mf.sha256_file(str(p))
    keys = ["b", "a", "c.weight"]
    assert mf.key_universe_digest(keys) == jax_mf.key_universe_digest(keys)
