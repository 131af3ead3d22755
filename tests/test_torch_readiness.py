"""The port's readiness tools on the CPU: sdeo-readiness-torch --dry-run
--cpu end to end, the manifest modes' exit codes and lines, the offline
drill's synth_state_dict against the JAX package's (byte for byte), the
port's safetensors writer and reader against each other and against the
safetensors package both ways, the pipeline store, and the drill's family
registry. The full-width drill families run on the card
(chip_smoke.py:drill_phase), as the JAX drill's run outside tier 1
(tests/test_offline_drill.py)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from stablediffusioneo_tpu.testing import offline_drill as jax_drill
from stablediffusioneo_tpu_torch.checkpoint import manifest as mf
from stablediffusioneo_tpu_torch.checkpoint import store, torch_reader
from stablediffusioneo_tpu_torch.checkpoint.accounting import ConversionAccountingError
from stablediffusioneo_tpu_torch.cli import readiness, smoke
from stablediffusioneo_tpu_torch.testing import offline_drill as drill


def test_dry_run_passes_on_the_cpu(capsys):
    assert readiness.main(["--dry-run", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "[accounting]" in out and "READINESS: PASS" in out
    assert out.count("PD=0.000") == 2


def test_parity_holds_the_latents_beside_the_pd(capsys):
    """parity() keeps each image's final latents: the same fp32 run on both
    sides gives error 0, and a request without the ControlNet (strength 0)
    or with another prompt moves them off the reference's."""
    r = readiness.parity(readiness.parse_args(["--dry-run", "--cpu"]))
    assert r["latent_errs"] == [0.0, 0.0]
    pipe, ref = r["pipeline"], r["ref_latents"][0]
    for prompt, strength in ((readiness.PROMPT, 0.0), ("a cat", 1.0)):
        pipe.process(r["images"][0], prompt, **dict(r["kwargs"], strength=strength))
        assert (pipe.last_latents.float() - ref).abs().max() > 1e-3 * ref.abs().max()


def test_dry_run_fails_above_the_limit(capsys):
    """A negative limit no distance meets: exit 1 and the FAIL line."""
    assert readiness.main(["--dry-run", "--cpu", "--pd-limit", "-1"]) == 1
    assert "READINESS: FAIL" in capsys.readouterr().out


def test_dry_run_saves_and_reuses_goldens(tmp_path, capsys):
    gold = tmp_path / "goldens"
    assert readiness.main(["--dry-run", "--cpu", "--save-goldens", str(gold)]) == 0
    assert sorted(os.listdir(gold)) == ["golden_0.png", "golden_1.png"]
    capsys.readouterr()
    assert readiness.main(["--dry-run", "--cpu", "--golden-dir", str(gold)]) == 0
    out = capsys.readouterr().out
    assert "[reference]" not in out and "READINESS: PASS" in out
    assert "latents" not in out


@pytest.fixture
def hed_file(tmp_path):
    uni = mf.load_universe("hed")
    p = tmp_path / "ControlNetHED.pth"
    torch.save({k: torch.zeros([int(d) for d in s.split("x")] or []) for k, s in uni.items()},
               str(p))
    return str(p)


def test_verify_manifest_mode(hed_file, tmp_path, capsys):
    assert readiness.main(["--verify-manifest", hed_file]) == 0
    assert capsys.readouterr().out.startswith(f"OK {hed_file}: ")
    bad = tmp_path / "ControlNetHED_copy" / "ControlNetHED.pth"
    bad.parent.mkdir()
    torch.save({"junk": torch.zeros(2)}, str(bad))
    assert readiness.main(["--verify-manifest", hed_file, str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"OK {hed_file}" in out and f"REJECTED {bad}:" in out
    assert "required keys missing" in out


def test_pin_manifest_mode_writes_the_given_manifest(hed_file, tmp_path, capsys):
    local = tmp_path / "manifest.json"
    shutil.copy(mf.default_manifest_path(), local)
    packaged = open(mf.default_manifest_path(), "rb").read()
    assert readiness.main(["--pin-manifest", hed_file, "--manifest", str(local)]) == 0
    assert capsys.readouterr().out.startswith(f"PINNED {hed_file}: sha256=")
    entry = json.loads(local.read_text())["artifacts"]["hed"]
    assert entry["sha256"] == mf.sha256_file(hed_file)
    assert open(mf.default_manifest_path(), "rb").read() == packaged
    assert readiness.main(["--verify-manifest", hed_file, "--manifest", str(local)]) == 0
    with open(hed_file, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    capsys.readouterr()
    assert readiness.main(["--verify-manifest", hed_file, "--manifest", str(local)]) == 1
    assert "sha256" in capsys.readouterr().out


@pytest.mark.parametrize("universe", ["hed", "mlsd_large", "openpose_hand", "pt_inception",
                                      "handmade"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synth_state_dict_is_the_jax_packages(universe, seed):
    uni = ({"a.weight": "4x3", "bn.running_var": "8", "bn.num_batches_tracked": "",
            "emb.position_ids": "1x77", "b.bias": "5"} if universe == "handmade"
           else mf.load_universe(universe))
    got = drill.synth_state_dict(uni, seed=seed)
    want = jax_drill.synth_state_dict(uni, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    if universe == "handmade":
        assert (got["bn.running_var"] > 0).all()
        assert got["bn.num_batches_tracked"].dtype == np.int64
        assert (got["emb.position_ids"] == np.arange(77)).all()


def _mixed():
    rng = np.random.default_rng(0)
    return {"a.weight": rng.standard_normal((3, 5)).astype(np.float32),
            "bn.num_batches_tracked": np.zeros((), np.int64),
            "emb.position_ids": np.arange(7, dtype=np.int64).reshape(1, 7),
            "h.weight": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)
                                    ).to(torch.bfloat16),
            "f16": rng.standard_normal(6).astype(np.float16),
            "empty": np.zeros((0, 3), np.float32),
            "mask": np.array([True, False, True]),
            "t.weight": rng.standard_normal((4, 6)).astype(np.float32).T}


def _as_tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def test_safetensors_writer_and_reader_round_trip(tmp_path):
    sd = _mixed()
    p = str(tmp_path / "x.safetensors")
    drill.write_safetensors(sd, p)
    got = torch_reader.load_torch_state_dict(p)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        v = _as_tensor(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    raw = open(p, "rb").read()
    hlen = int.from_bytes(raw[:8], "little")
    assert hlen % 8 == 0 and raw[8:9] == b"{"


def test_safetensors_package_reads_the_ports_files_and_back(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    sd = _mixed()
    p = str(tmp_path / "port.safetensors")
    drill.write_safetensors(sd, p)
    theirs = st.load_file(p)
    assert theirs.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(theirs[k], _as_tensor(v)), k
    q = str(tmp_path / "theirs.safetensors")
    st.save_file({k: _as_tensor(v).contiguous() for k, v in sd.items()}, q,
                 metadata={"format": "pt"})
    ours = torch_reader.load_torch_state_dict(q)
    assert ours.keys() == sd.keys()
    for k, v in sd.items():
        assert ours[k].dtype == _as_tensor(v).dtype and torch.equal(ours[k], _as_tensor(v)), k


def test_write_pth_round_trips_through_the_ports_reader(tmp_path):
    sd = drill.synth_state_dict({"w": "2x3", "bn.num_batches_tracked": "", "p.position_ids": "1x4"})
    got = torch_reader.load_torch_state_dict(drill.write_pth(sd, str(tmp_path / "x.pth")))
    assert all(got[k].numpy().tobytes() == v.tobytes() and got[k].numpy().dtype == v.dtype
               for k, v in sd.items())


def test_store_round_trips(tmp_path):
    from stablediffusioneo_tpu_torch.config import tiny_pipeline
    from stablediffusioneo_tpu_torch.models.cldm import ControlLDM, init_weights

    cfg = tiny_pipeline()
    model = ControlLDM(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    trees = {"unet": model.unet, "controlnet": model.control_model.state_dict(),
             "vae": model.first_stage_model, "clip": model.clip}
    half = {"vae": {k: v.to(torch.bfloat16) for k, v in model.first_stage_model
                    .state_dict().items()}}
    store.save_pipeline(str(tmp_path / "snap"), trees)
    store.save_pipeline(str(tmp_path / "half"), half)
    fresh = ControlLDM(cfg)
    like = {"unet": fresh.unet, "controlnet": fresh.control_model,
            "vae": fresh.first_stage_model, "clip": fresh.clip}
    assert store.load_pipeline(str(tmp_path / "snap"), like) is like
    for a, b in zip(fresh.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "snap")) == [
        "clip.safetensors", "controlnet.safetensors", "unet.safetensors", "vae.safetensors"]
    # a bf16 snapshot loads into the fp32 module, cast on copy
    other = ControlLDM(cfg)
    store.load_pipeline(str(tmp_path / "half"), {"vae": other.first_stage_model})
    want = {k: v.to(torch.bfloat16).float() for k, v in model.first_stage_model
            .state_dict().items()}
    assert all(torch.equal(other.first_stage_model.state_dict()[k], v) for k, v in want.items())
    # a snapshot of another network is refused by its keys
    with pytest.raises(ConversionAccountingError):
        store.load_pipeline(str(tmp_path / "snap"), {"vae": ControlLDM(cfg).unet})


def test_drill_family_registry_is_total():
    assert drill.ALL_FAMILIES == jax_drill.ALL_FAMILIES
    assert drill._FAMILY_ARTIFACTS == jax_drill._FAMILY_ARTIFACTS
    assert set(drill._FAMILY_ARTIFACTS) == set(drill.ALL_FAMILIES)
    assert set(drill._RUNNERS) | {"sd15", "sdxl"} == set(drill.ALL_FAMILIES)
    assert set(drill._RUNNERS) == set(jax_drill._RUNNERS)
    artifacts = mf.load_manifest()["artifacts"]
    for fam, names in drill._FAMILY_ARTIFACTS.items():
        for name in names:
            assert artifacts[name]["universe"] == name, (fam, name)
            assert mf.load_universe(name)
    with pytest.raises(ValueError, match="unknown drill family"):
        drill.run_drill(("nope",), device="cpu")


def test_finite_u8_refuses_other_dtypes():
    drill._finite_u8(np.zeros((2, 2, 3), np.uint8), "ok")
    with pytest.raises(AssertionError, match="dtype"):
        drill._finite_u8(np.zeros((2, 2), np.float32), "img")


def test_smoke_cli_tiny_on_the_cpu(capsys):
    assert smoke.main(["--tiny", "--cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("clip engine OK: (1, 16, 64) torch.float32 mean|x|= ")
    assert out[1] == "{'compiled': False}"


@pytest.mark.parametrize("argv", [[], ["--ckpt", "x.pth"], ["--verify-manifest"]],
                         ids=["nothing", "ckpt alone", "verify nothing"])
def test_argument_errors(argv):
    with pytest.raises(SystemExit) as e:
        readiness.main(argv)
    assert e.value.code == 2
