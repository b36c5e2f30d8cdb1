"""Forge — the model zoo: package, store, fetch trained workflows.

Port of ``veles_tpu/forge.py``.  A package is one tar.gz holding
``manifest.json`` + the snapshot file (+ optionally an export artifact);
the store is a directory (a local path or a network mount;
``forge_server`` adds an HTTP transport over one).  The package layout
and the manifest keys are the reference's, so either package lists and
reads the other's store; the snapshot inside stays in its own package's
format (the port's snapshotter refuses a reference snapshot and points
at ``snapshotter.state_from_reference``).

API: ``pack`` → package file; ``publish`` → store; ``list_store`` /
``fetch`` → retrieve; ``load_artifact`` → served model;
``restore_package`` → live workflow.
"""

from __future__ import annotations

import json
import os
import shutil
import tarfile
import tempfile
import time

MANIFEST = "manifest.json"


def _safe_member(name):
    """Reject manifest-controlled member names that could escape the
    extraction directory (path traversal via '../' or absolute paths): a
    member must be a bare file name.  Packages are UNTRUSTED once fetched
    from a shared store."""
    if (not name or os.path.basename(name) != name
            or name in (os.curdir, os.pardir)):
        raise ValueError("unsafe member name in forge manifest: %r" % (name,))
    return name


def pack(snapshot_path, out_path, name=None, author=None, description="",
         metrics=None, extra_files=(), artifact_path=None):
    """Create a forge package from a snapshot file.

    ``artifact_path`` optionally bundles an export artifact
    (``veles_tpu_torch.export``) so the package can be served without
    the framework as well as restored for resume or fine-tuning."""
    if not os.path.exists(snapshot_path):
        raise FileNotFoundError(snapshot_path)
    manifest = {
        "name": name or os.path.basename(snapshot_path).split("_")[0],
        "author": author or os.environ.get("USER", "unknown"),
        "description": description,
        "metrics": metrics or {},
        "snapshot": os.path.basename(snapshot_path),
        "packaged_at": time.time(),
        "format": 1,
    }
    if artifact_path is not None:
        if not os.path.exists(artifact_path):
            raise FileNotFoundError(artifact_path)
        manifest["artifact"] = os.path.basename(artifact_path)
    with tarfile.open(out_path, "w:gz") as tar:
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(manifest, f, indent=2)
            tmp = f.name
        tar.add(tmp, arcname=MANIFEST)
        os.unlink(tmp)
        tar.add(snapshot_path, arcname=manifest["snapshot"])
        if artifact_path is not None:
            tar.add(artifact_path, arcname=manifest["artifact"])
        for path in extra_files:
            tar.add(path, arcname=os.path.basename(path))
    return out_path


def read_manifest(package_path):
    with tarfile.open(package_path, "r:gz") as tar:
        member = tar.extractfile(MANIFEST)
        if member is None:
            raise ValueError("%s has no %s" % (package_path, MANIFEST))
        return json.load(member)


def unpack(package_path, out_dir):
    """Extract a package; returns (manifest, snapshot_path)."""
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(package_path, "r:gz") as tar:
        tar.extractall(out_dir, filter="data")
    with open(os.path.join(out_dir, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    return manifest, os.path.join(out_dir, _safe_member(manifest["snapshot"]))


def publish(package_path, store_dir):
    """Upload to the store (versioned by name + timestamp).

    Atomic: staged under a non-package suffix, then renamed — concurrent
    ``list_store`` readers (e.g. forge_server /list) never see a
    half-copied package."""
    manifest = read_manifest(package_path)
    os.makedirs(store_dir, exist_ok=True)
    dest = os.path.join(store_dir, "%s_%d.forge.tar.gz"
                        % (manifest["name"], int(manifest["packaged_at"])))
    staging = dest + ".publish.tmp"
    try:
        shutil.copyfile(package_path, staging)
        os.replace(staging, dest)
    except BaseException:
        if os.path.exists(staging):
            os.unlink(staging)
        raise
    return dest


def list_store(store_dir):
    """[(package_path, manifest)] sorted newest-first."""
    out = []
    if not os.path.isdir(store_dir):
        return out
    for fname in sorted(os.listdir(store_dir), reverse=True):
        if fname.endswith(".forge.tar.gz"):
            path = os.path.join(store_dir, fname)
            out.append((path, read_manifest(path)))
    return out


def fetch(store_dir, name, out_dir):
    """Fetch the newest package named ``name``; returns (manifest,
    snapshot_path)."""
    for path, manifest in list_store(store_dir):
        if manifest["name"] == name:
            return unpack(path, out_dir)
    raise KeyError("no package %r in %s" % (name, store_dir))


def load_artifact(package_path, out_dir=None, device=None):
    """Load the bundled export artifact of a package as an ExportedModel
    on ``device`` (None: the CUDA card, raising without one); raises
    KeyError if the package has none.

    Only the artifact member is extracted — the (possibly multi-GB)
    training snapshot never touches disk on the serving path."""
    from veles_tpu_torch.export import load_model
    manifest = read_manifest(package_path)
    if "artifact" not in manifest:
        raise KeyError("package %s carries no export artifact"
                       % package_path)
    artifact_name = _safe_member(manifest["artifact"])  # before mkdtemp
    cleanup = out_dir is None
    out_dir = out_dir or tempfile.mkdtemp(prefix="forge_")
    artifact_path = os.path.join(out_dir, artifact_name)
    try:
        with tarfile.open(package_path, "r:gz") as tar:
            member = tar.extractfile(manifest["artifact"])
            if member is None:
                raise ValueError("%s: manifest names artifact %r but the "
                                 "member is missing"
                                 % (package_path, manifest["artifact"]))
            os.makedirs(out_dir, exist_ok=True)
            with open(artifact_path, "wb") as f:
                shutil.copyfileobj(member, f)
        return load_model(artifact_path, device=device)
    finally:
        if cleanup:
            shutil.rmtree(out_dir, ignore_errors=True)


def restore_package(package_path, build, out_dir=None):
    """Unpack + restore into a live workflow: ``build()`` must return the
    initialized workflow (the snapshot is the artifact)."""
    from veles_tpu_torch import snapshotter
    out_dir = out_dir or tempfile.mkdtemp(prefix="forge_")
    manifest, snapshot_path = unpack(package_path, out_dir)
    wf = build()
    snapshotter.restore(wf, snapshot_path)
    return wf, manifest
