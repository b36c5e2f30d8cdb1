"""The port's forge (``veles_tpu_torch.forge``, ``forge_server``,
``forge_cli``) on the CPU: the reference's ``TestForge*`` cases
(``tests/test_services.py``, ``tests/test_export.py``) run on the port,
and each package's ``read_manifest`` and ``list_store`` read the
other's store.  Snapshots stay in each package's own format: the port's
``restore_package`` refuses a reference snapshot.

The tiny MNIST-FC is ``tests/test_services.py``'s (hidden 16, 200
train / 100 validation, minibatch 50, 2 epochs, seed 1); restored
weights are equal bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import tarfile
import urllib.error
from pathlib import Path

import numpy
import pytest
import torch

from veles_tpu import forge as jax_forge
from veles_tpu import prng as jax_prng
from veles_tpu.config import root as jax_root
from veles_tpu.samples import mnist as jax_mnist
from veles_tpu.snapshotter import Snapshotter as JaxSnapshotter
from veles_tpu_torch import export, forge, forge_server, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.samples import mnist
from veles_tpu_torch.snapshotter import Snapshotter

REPO = Path(__file__).resolve().parent.parent
SEED = 1
MNIST = {
    "loader": {"minibatch_size": 50, "n_train": 200, "n_valid": 100},
    "decision": {"max_epochs": 2, "fail_iterations": 5},
    "layers": [
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "learning_rate": 0.03, "momentum": 0.9},
        {"type": "softmax", "output_sample_shape": 10,
         "learning_rate": 0.03, "momentum": 0.9},
    ],
}


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = root.__dict__.pop("mnist", None)
    yield
    root.__dict__.pop("mnist", None)
    if saved is not None:
        root.__dict__["mnist"] = saved
    torch.set_num_threads(threads)
    prng.reset()


def _train(tmp_path, snapshot=False):
    prng.reset()
    prng.seed_all(SEED)
    cfg = dict(MNIST)
    if snapshot:
        cfg["snapshotter"] = {"directory": str(tmp_path / "snaps"),
                              "interval": 1, "compression": "gz"}
    root.mnist.update(cfg)
    return mnist.train(device="cpu")


def _build_fresh():
    """A freshly built, initialized workflow of the same config under
    another seed (a restore must overwrite its initial weights)."""
    prng.reset()
    prng.seed_all(99)
    root.__dict__.pop("mnist", None)
    root.mnist.update(MNIST)
    wf = mnist.build()
    wf.initialize(device="cpu")
    return wf


def _weights(wf):
    return [numpy.array(v.mem) for f in wf.forwards if f.has_params
            for v in (f.weights, f.bias)]


def _assert_same_weights(a, b):
    for x, y in zip(_weights(a), _weights(b), strict=True):
        numpy.testing.assert_array_equal(x, y)


def _snapshot_of(wf, tmp_path, name="snap"):
    return Snapshotter(wf, directory=str(tmp_path / "s"),
                       name=name).export()


class TestForge:
    def test_pack_publish_fetch_restore(self, tmp_path):
        wf = _train(tmp_path, snapshot=True)
        snap = wf.snapshotter.destination
        assert snap and os.path.exists(snap)
        pkg = forge.pack(snap, str(tmp_path / "model.forge.tar.gz"),
                         name="mnist_fc", description="test model",
                         metrics={"n_err": wf.decision.best_metric})
        manifest = forge.read_manifest(pkg)
        assert manifest["name"] == "mnist_fc"
        assert manifest["metrics"]["n_err"] == wf.decision.best_metric
        store = str(tmp_path / "store")
        forge.publish(pkg, store)
        listed = forge.list_store(store)
        assert len(listed) == 1 and listed[0][1]["name"] == "mnist_fc"
        _, snap_path = forge.fetch(store, "mnist_fc",
                                   str(tmp_path / "fetched"))
        assert os.path.exists(snap_path)
        with pytest.raises(KeyError):
            forge.fetch(store, "nope", str(tmp_path / "f2"))
        wf2, _ = forge.restore_package(pkg, _build_fresh,
                                       out_dir=str(tmp_path / "restored"))
        _assert_same_weights(wf2, wf)

    def test_package_carries_and_serves_artifact(self, tmp_path):
        wf = _train(tmp_path)
        artifact = export.export_model(wf, str(tmp_path / "mnist.veles"))
        pkg = str(tmp_path / "mnist.forge.tar.gz")
        forge.pack(_snapshot_of(wf, tmp_path), pkg, name="mnist-test",
                   artifact_path=artifact, metrics={"val_err": 1})
        assert forge.read_manifest(pkg)["artifact"] == "mnist.veles"
        model = forge.load_artifact(pkg, out_dir=str(tmp_path / "un"),
                                    device="cpu")
        x = numpy.asarray(wf.loader.original_data.mem[:2])
        runner = wf._fused_runner
        numpy.testing.assert_array_equal(
            model.predict(x),
            runner.eval_forward()(runner.state, torch.from_numpy(x)).numpy())
        # without out_dir the extraction directory is removed after
        assert forge.load_artifact(pkg, device="cpu").predict(x).shape \
            == (2, 10)
        plain = str(tmp_path / "plain.forge.tar.gz")
        forge.pack(_snapshot_of(wf, tmp_path, "plain"), plain, name="plain")
        with pytest.raises(KeyError):
            forge.load_artifact(plain, out_dir=str(tmp_path / "u2"),
                                device="cpu")


class TestForgeTraversal:
    """A crafted package whose manifest names members outside the
    extraction dir must be rejected (packages are untrusted once
    fetched)."""

    def _evil_package(self, tmp_path, key, member):
        pkg = str(tmp_path / "evil.forge.tar.gz")
        manifest = {"name": "evil", "snapshot": "snap.bin", "format": 1,
                    "packaged_at": 0, key: member}
        payload = tmp_path / "payload.bin"
        payload.write_bytes(b"owned")
        with tarfile.open(pkg, "w:gz") as tar:
            mf = tmp_path / "manifest.json"
            mf.write_text(json.dumps(manifest))
            tar.add(str(mf), arcname="manifest.json")
            tar.add(str(payload), arcname="snap.bin")
        return pkg

    @pytest.mark.parametrize("key,member,call", [
        ("artifact", "../evil.bin", "load_artifact"),
        ("snapshot", "../../snap.bin", "unpack"),
        ("artifact", "/tmp/evil.bin", "load_artifact"),
        ("snapshot", ".", "unpack"),
    ])
    def test_unsafe_members_rejected(self, tmp_path, key, member, call):
        pkg = self._evil_package(tmp_path, key, member)
        with pytest.raises(ValueError, match="unsafe member"):
            if call == "unpack":
                forge.unpack(pkg, str(tmp_path / "out"))
            else:
                forge.load_artifact(pkg, out_dir=str(tmp_path / "out"),
                                    device="cpu")
        assert not (tmp_path / "evil.bin").exists()


class TestForgeServer:
    def test_upload_list_fetch_roundtrip(self, tmp_path):
        wf = _train(tmp_path, snapshot=True)
        pkg = forge.pack(wf.snapshotter.destination,
                         str(tmp_path / "m.forge.tar.gz"), name="mnist_fc",
                         metrics={"n_err": wf.decision.best_metric})
        server = forge_server.ForgeServer(str(tmp_path / "store")).start()
        try:
            assert forge_server.upload(pkg, server.url)["name"] == "mnist_fc"
            listing = forge_server.list_remote(server.url)
            assert len(listing) == 1 and listing[0][1]["name"] == "mnist_fc"
            manifest, snap_path = forge_server.fetch_remote(
                server.url, "mnist_fc", str(tmp_path / "fetched"))
            assert manifest["name"] == "mnist_fc"
            from veles_tpu_torch import snapshotter
            wf2 = _build_fresh()
            snapshotter.restore(wf2, snap_path)
            _assert_same_weights(wf2, wf)
        finally:
            server.stop()

    def test_rejects_garbage_and_unknown(self, tmp_path):
        server = forge_server.ForgeServer(str(tmp_path / "store")).start()
        try:
            garbage = tmp_path / "garbage.bin"
            garbage.write_bytes(b"this is not a tarball")
            with pytest.raises(urllib.error.HTTPError) as err:
                forge_server.upload(str(garbage), server.url)
            assert err.value.code == 400
            assert forge_server.list_remote(server.url) == []
            with pytest.raises(urllib.error.HTTPError) as err:
                forge_server.fetch_remote(server.url, "nope",
                                          str(tmp_path / "out"))
            assert err.value.code == 404
            with pytest.raises(ValueError, match="unsafe package name"):
                forge_server.fetch_remote(server.url, "../evil",
                                          str(tmp_path / "out"))
        finally:
            server.stop()


def _cli(*args, timeout=300):
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.forge_cli", *args],
        capture_output=True, text=True, cwd=str(REPO), timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


class TestForgeCLI:
    def test_pack_publish_list_fetch_roundtrip(self, tmp_path):
        wf = _train(tmp_path)
        snap = _snapshot_of(wf, tmp_path, "snapcli")
        pkg = str(tmp_path / "m.forge.tar.gz")
        _cli("pack", snap, pkg, "--name", "cli-model",
             "--metric", "n_err=3", "--description", "from the CLI")
        _cli("publish", pkg, str(tmp_path / "store"))
        entries = json.loads(_cli("list", str(tmp_path / "store")))
        assert any(m["name"] == "cli-model" for _, m in entries)
        out = json.loads(_cli("fetch", str(tmp_path / "store"),
                              "cli-model", str(tmp_path / "got")))
        assert out["manifest"]["metrics"]["n_err"] == 3
        assert os.path.exists(out["snapshot"])

    def test_cli_url_store_flow(self, tmp_path):
        wf = _train(tmp_path)
        pkg = str(tmp_path / "u.forge.tar.gz")
        forge.pack(_snapshot_of(wf, tmp_path, "snapurl"), pkg,
                   name="url-model")
        server = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch.forge_cli", "serve",
             str(tmp_path / "rstore"), "--port", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=str(REPO))
        try:
            line = server.stdout.readline()
            assert line.startswith("FORGE "), line
            url = line.split()[1].strip()
            _cli("upload", pkg, url)
            _cli("publish", pkg, url)       # a URL store: upload, no mkdir
            assert not (REPO / "http:").exists()
            entries = json.loads(_cli("list", url))
            assert any(m["name"] == "url-model" for _, m in entries)
            out = json.loads(_cli("fetch", url, "url-model",
                                  str(tmp_path / "rgot")))
            assert os.path.exists(out["snapshot"])
        finally:
            server.send_signal(signal.SIGINT)
            try:
                server.wait(timeout=15)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait()

    def test_cli_bad_metric_rejected(self):
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch.forge_cli", "pack",
             "snap", "out", "--metric", "n_err"],
            capture_output=True, text=True, cwd=str(REPO), timeout=120)
        assert proc.returncode == 2
        assert "KEY=VALUE" in proc.stderr


class TestAcrossPackages:
    """One store format: each package lists and reads the other's
    packages; each restores only its own snapshots."""

    def _reference_package(self, tmp_path):
        saved = jax_root.__dict__.pop("mnist", None)
        try:
            jax_prng.reset()
            jax_prng.seed_all(SEED)
            jax_root.mnist.update(MNIST)
            ref = jax_mnist.train()
            snap = JaxSnapshotter(ref, directory=str(tmp_path / "js"),
                                  name="jsnap").export()
        finally:
            jax_root.__dict__.pop("mnist", None)
            if saved is not None:
                jax_root.__dict__["mnist"] = saved
            jax_prng.reset()
        return jax_forge.pack(snap, str(tmp_path / "ref.forge.tar.gz"),
                              name="ref-model", metrics={"n_err": 1})

    def test_each_package_reads_the_others_store(self, tmp_path):
        store = str(tmp_path / "store")
        ref_pkg = self._reference_package(tmp_path)
        jax_forge.publish(ref_pkg, store)
        wf = _train(tmp_path)
        pkg = forge.pack(_snapshot_of(wf, tmp_path),
                         str(tmp_path / "port.forge.tar.gz"),
                         name="port-model")
        forge.publish(pkg, store)
        ours = {m["name"]: (os.path.basename(p), m)
                for p, m in forge.list_store(store)}
        theirs = {m["name"]: (os.path.basename(p), m)
                  for p, m in jax_forge.list_store(store)}
        assert ours == theirs and set(ours) == {"ref-model", "port-model"}
        assert set(ours["ref-model"][1]) == set(ours["port-model"][1])
        assert forge.read_manifest(ref_pkg) == \
            jax_forge.read_manifest(ref_pkg)
        assert jax_forge.read_manifest(pkg) == forge.read_manifest(pkg)

    def test_port_refuses_a_reference_snapshot(self, tmp_path):
        ref_pkg = self._reference_package(tmp_path)
        with pytest.raises(ValueError, match="state_from_reference"):
            forge.restore_package(ref_pkg, _build_fresh,
                                  out_dir=str(tmp_path / "r"))
