"""Weight-acquisition manifest: integrity and structure gates for the
external checkpoints (counterpart of stablediffusioneo_tpu/checkpoint/
manifest.py, with its functions, reports and error messages).

- ``weights_manifest.json`` (packaged with this package) lists every
  external artifact: filename, role, documented public source, expected
  structure (key count, key-universe digest, allowed extra-key patterns),
  and, once pinned, sha256 + byte size.
- ``universes/<name>.txt.gz`` (packaged) holds the REQUIRED key universe
  (``key<TAB>shape`` lines) of each artifact at its real widths, so
  verification needs no network and no model.
- ``verify_file`` rejects a tampered, renamed, or wrong-family file naming
  the exact mismatch; ``pin_file`` records sha256/size on first trusted
  contact, into the manifest file it is given (default: this package's), so
  every later run enforces bit-identity.

The manifest and the universes are copies of the JAX package's, held to
them byte for byte by tests/test_torch_imports.py.

Structure check semantics: required is a subset of actual, and every extra
key must match an entry's ``allowed_extra`` regex list (the
checkpoint-format artifacts the loaders deliberately ignore, e.g. DDPM
schedule buffers: ``accounting.SD_KNOWN_UNUSED``). Shapes are compared for
every required key. The file is read by this package's own reader
(checkpoint/torch_reader.py). The deep per-key gate stays where it always
was: strict key accounting at load time.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import re
from typing import Dict, List, Optional

__all__ = [
    "ManifestError",
    "default_manifest_path",
    "key_universe_digest",
    "load_manifest",
    "load_universe",
    "pin_file",
    "sha256_file",
    "verify_file",
]

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_MANIFEST = os.path.join(_PKG_DIR, "weights_manifest.json")
_UNIVERSES = os.path.join(_PKG_DIR, "universes")


class ManifestError(RuntimeError):
    """A file failed manifest verification; the message names every
    mismatch."""


def default_manifest_path() -> str:
    return _MANIFEST


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def key_universe_digest(keys) -> str:
    """Order-independent digest of a key set (names only)."""
    return hashlib.sha256(
        "\n".join(sorted(keys)).encode("utf-8")).hexdigest()


def load_manifest(path: Optional[str] = None) -> Dict:
    with open(path or _MANIFEST) as f:
        return json.load(f)


def load_universe(name: str, universes_dir: Optional[str] = None) -> Dict[str, str]:
    """Required key universe for an artifact: {key: shape_str}."""
    p = os.path.join(universes_dir or _UNIVERSES, f"{name}.txt.gz")
    out: Dict[str, str] = {}
    with gzip.open(p, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            k, _, shape = line.partition("\t")
            out[k] = shape
    return out


def _shape_str(shape) -> str:
    return "x".join(str(int(d)) for d in shape)


def _match_entry(manifest: Dict, path: str, name: Optional[str]):
    base = os.path.basename(path)
    entries = manifest["artifacts"]
    if name is not None:
        if name not in entries:
            raise ManifestError(
                f"unknown artifact name {name!r}; manifest has: "
                f"{sorted(entries)}")
        return name, entries[name]
    for n, e in entries.items():
        if e["filename"] == base:
            return n, e
    raise ManifestError(
        f"{base!r} matches no manifest artifact (renamed file?); known "
        f"filenames: {sorted(e['filename'] for e in entries.values())}")


def _verify_structure(name: str, entry: Dict, path: str,
                      universes_dir: Optional[str],
                      problems: List[str]) -> Dict:
    fmt = entry.get("format", "torch_sd")
    info: Dict = {}
    if fmt == "torch_sd":
        from stablediffusioneo_tpu_torch.checkpoint.torch_reader import (
            load_torch_state_dict,
        )

        sd = load_torch_state_dict(path)
        actual = {k: _shape_str(getattr(v, "shape", ())) for k, v in sd.items()}
        info["key_count"] = len(actual)
        if entry.get("universe"):
            required = load_universe(entry["universe"], universes_dir)
            missing = sorted(set(required) - set(actual))
            if missing:
                problems.append(
                    f"{len(missing)} required keys missing "
                    f"(wrong family/config?), e.g. {missing[:4]}")
            allowed = [re.compile(p + r"\Z")
                       for p in entry.get("allowed_extra", [])]
            extras = sorted(set(actual) - set(required))
            bad_extras = [k for k in extras
                          if not any(p.match(k) for p in allowed)]
            if bad_extras:
                problems.append(
                    f"{len(bad_extras)} unexpected keys, e.g. "
                    f"{bad_extras[:4]}")
            shape_bad = [
                f"{k}: expected {required[k]}, got {actual[k]}"
                for k in required
                if k in actual and required[k] and required[k] != actual[k]
            ]
            if shape_bad:
                problems.append(
                    f"{len(shape_bad)} shape mismatches, e.g. "
                    f"{shape_bad[:3]}")
            info["required_keys"] = len(required)
            info["extra_keys"] = len(extras)
    elif fmt == "json_vocab":
        with open(path, encoding="utf-8") as f:
            vocab = json.load(f)
        info["entries"] = len(vocab)
        want = entry.get("expected_entries")
        if want is not None and len(vocab) != want:
            problems.append(
                f"vocab has {len(vocab)} entries, expected {want}")
    elif fmt == "text_merges":
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        info["lines"] = len(lines)
        if not (lines and lines[0].startswith("#version")):
            problems.append("merges file missing '#version' header line")
        lo = entry.get("min_lines")
        if lo is not None and len(lines) < lo:
            problems.append(f"merges has {len(lines)} lines, expected "
                            f">= {lo}")
    else:
        problems.append(f"unknown manifest format {fmt!r}")
    return info


def verify_file(path: str, name: Optional[str] = None,
                manifest: Optional[Dict] = None,
                manifest_path: Optional[str] = None,
                universes_dir: Optional[str] = None,
                structure: bool = True) -> Dict:
    """Verify one downloaded artifact. Raises :class:`ManifestError` naming
    every mismatch; returns a report dict on success."""
    manifest = manifest or load_manifest(manifest_path)
    name, entry = _match_entry(manifest, path, name)
    problems: List[str] = []
    report: Dict = {"artifact": name, "path": path}

    size = os.path.getsize(path)
    report["size_bytes"] = size
    if entry.get("size_bytes") is not None and size != entry["size_bytes"]:
        problems.append(
            f"size {size} B != pinned {entry['size_bytes']} B")
    if entry.get("sha256"):
        digest = sha256_file(path)
        report["sha256"] = digest
        if digest != entry["sha256"]:
            problems.append(
                f"sha256 {digest[:16]}… != pinned {entry['sha256'][:16]}…")
    else:
        report["sha256"] = None  # unpinned: structure checks only

    if structure and not problems:
        # structure checks are pointless on a file that already failed
        # bit-identity — and parsing a tampered pickle is exactly what we
        # want to avoid
        report.update(_verify_structure(name, entry, path, universes_dir,
                                        problems))
    if problems:
        raise ManifestError(
            f"{entry['filename']} failed manifest verification:\n  - "
            + "\n  - ".join(problems))
    report["ok"] = True
    return report


def pin_file(path: str, name: Optional[str] = None,
             manifest_path: Optional[str] = None) -> Dict:
    """First trusted contact: verify structure, then record sha256 + size
    into the manifest json at `manifest_path` (default: this package's) so
    later runs enforce bit-identity."""
    mp = manifest_path or _MANIFEST
    manifest = load_manifest(mp)
    name, entry = _match_entry(manifest, path, name)
    # structure must hold BEFORE we pin — pinning a wrong-family file
    # would bless it forever
    problems: List[str] = []
    _verify_structure(name, entry, path, None, problems)
    if problems:
        raise ManifestError(
            f"refusing to pin {entry['filename']}:\n  - "
            + "\n  - ".join(problems))
    entry["sha256"] = sha256_file(path)
    entry["size_bytes"] = os.path.getsize(path)
    with open(mp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return entry
