"""Package rules of the PyTorch port: it never imports ``jax`` or
``veles_tpu``, and its entry points refuse to run without a card unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "veles_tpu_torch"


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_jax_and_reference_out():
    code = ("import importlib, sys\n"
            "for name in %r:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
            "             m.startswith(('jax.', 'jaxlib', 'veles_tpu.'))\n"
            "             or m == 'veles_tpu')\n"
            "print('BAD=%%s' %% bad)\n" % (list(_modules()),))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=[]" in out.stdout, out.stdout


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_import_anywhere():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "veles_tpu"}, path


def test_new_data_path_modules_are_checked():
    """The data-path modules are among those the two checks above
    import and parse."""
    names = set(_modules())
    assert {"veles_tpu_torch.native", "veles_tpu_torch.loader.records",
            "veles_tpu_torch.loader.mdb", "veles_tpu_torch.loader.lmdb",
            "veles_tpu_torch.loader.pickles", "veles_tpu_torch.loader.image",
            "veles_tpu_torch.samples.wine",
            "veles_tpu_torch.samples.image_dir"} <= names


def test_non_sgd_slice_modules_are_checked():
    """The non-SGD trainers, their samples and the stream modules are
    among those the two checks above import and parse."""
    names = set(_modules())
    assert {"veles_tpu_torch.ops.kohonen", "veles_tpu_torch.ops.rbm",
            "veles_tpu_torch.samples.kohonen",
            "veles_tpu_torch.samples.mnist_rbm",
            "veles_tpu_torch.samples.lines",
            "veles_tpu_torch.samples.video_ae",
            "veles_tpu_torch.loader.stream",
            "veles_tpu_torch.loader.interactive",
            "veles_tpu_torch.loader.saver",
            "veles_tpu_torch.input_joiner"} <= names


def test_harness_modules_are_checked():
    """The run harness — the CLI, launcher, snapshotter, lr policies and
    the epoch-scan driver — is among the modules the two checks above
    import and parse."""
    names = set(_modules())
    assert {"veles_tpu_torch.__main__", "veles_tpu_torch.launcher",
            "veles_tpu_torch.snapshotter", "veles_tpu_torch.epoch_driver",
            "veles_tpu_torch.ops.lr_adjust"} <= names


def test_deployment_modules_are_checked():
    """The deployment slice — export, the native runner's build, the
    REST predict path with its micro-batcher, and the forge — is among
    the modules the two checks above import and parse."""
    names = set(_modules())
    assert {"veles_tpu_torch.export", "veles_tpu_torch.native",
            "veles_tpu_torch.restful_api",
            "veles_tpu_torch.serving.batcher", "veles_tpu_torch.forge",
            "veles_tpu_torch.forge_server",
            "veles_tpu_torch.forge_cli"} <= names


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    import numpy
    from veles_tpu_torch import export, prng, restful_api
    from veles_tpu_torch.compiled import (state_from_jax,
                                          trainer_state_from_jax)
    from veles_tpu_torch.config import root
    from veles_tpu_torch.device import resolve_device
    from veles_tpu_torch.ops.transformer import (TransformerLM,
                                                 params_from_jax)
    from veles_tpu_torch.loader.records import write_records
    from veles_tpu_torch.samples import (char_lm, cifar, cifar_resnet,
                                         image_dir, imagenet, kohonen,
                                         lines, mnist, mnist_ae,
                                         mnist_conv, mnist_rbm, video_ae,
                                         wine)
    from veles_tpu_torch.serving import LMEngine
    from veles_tpu_torch.workflow import Workflow
    from veles_tpu_torch import __main__ as cli
    from veles_tpu_torch.launcher import Launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prng.reset()
    root.mnist.update({"loader": {"n_train": 200, "n_valid": 100}})
    root.char_lm.update({"loader": {"n_train": 8, "n_valid": 4,
                                    "seq_len": 8}})
    lm = char_lm.build()
    lm.loader.initialize(device="cpu")
    tree = {"embed": torch.zeros(4, 8).numpy(), "blocks": [],
            "ln_f": {"g": torch.ones(8).numpy(),
                     "b": torch.zeros(8).numpy()}}
    records = str(tmp_path / "set.rec")
    write_records(records, numpy.zeros((4, 8, 8, 3), numpy.uint8),
                  numpy.zeros(4, numpy.int32), [0, 2, 2])

    root.mnist.update({"loader": {"minibatch_size": 50},
                       "decision": {"max_epochs": 1},
                       "layers": [{"type": "softmax",
                                   "output_sample_shape": 10}]})
    on_cpu = mnist.train(device="cpu")
    artifact = export.export_model(on_cpu, str(tmp_path / "a.veles"))

    def imagenet_records():
        root.__dict__.pop("imagenet", None)
        root.imagenet.loader.records_path = records
        try:
            imagenet.train()
        finally:
            root.__dict__.pop("imagenet", None)

    for call in (lambda: resolve_device(None),
                 lambda: params_from_jax(tree),
                 lambda: TransformerLM.from_jax(tree),
                 lambda: LMEngine(tree, 2, 16),
                 lambda: Workflow(None, name="wf").initialize(),
                 lambda: mnist.build().initialize(),
                 lambda: mnist.train(),
                 lambda: imagenet.build().initialize(),
                 lambda: imagenet.train(),
                 imagenet_records,
                 lambda: wine.train(),
                 lambda: image_dir.train(loader={"directory": str(tmp_path)}),
                 lambda: cifar.train(),
                 lambda: mnist_conv.train(),
                 lambda: cifar_resnet.train(),
                 lambda: mnist_ae.train(),
                 lambda: char_lm.build().initialize(),
                 lambda: char_lm.train(),
                 lambda: char_lm.train(trainer={"n_experts": 4}),
                 lambda: lm.trainer.initialize(),
                 lambda: state_from_jax([{"w": torch.zeros(2).numpy()}]),
                 lambda: kohonen.train(),
                 lambda: mnist_rbm.train(),
                 lambda: lines.train(),
                 lambda: video_ae.train(),
                 lambda: trainer_state_from_jax({"time": 0}),
                 lambda: export.load_model(artifact),
                 lambda: restful_api.serve_artifact(artifact, port=0),
                 # a bundle is compiled for its workflow's device, and a
                 # workflow reaches the card only through initialize
                 lambda: export.export_native_bundle(
                     mnist.build().initialize(), str(tmp_path / "bundle")),
                 lambda: Launcher(mnist.build(), stats=False).boot(),
                 lambda: cli.main(["veles_tpu_torch.samples.mnist",
                                   "--no-stats"]),
                 lambda: cli.main(["veles_tpu_torch.samples.mnist",
                                   "--no-stats", "--epoch-scan", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    from veles_tpu_torch.ops import hopper_kernels as HK
    q = torch.zeros(1, 2, 1, 4, device="meta")
    pool = torch.zeros(3, 2, 4, 4, device="meta")
    ptab = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.paged_flash_decode(q, pool, pool, ptab, pos)
    p = torch.zeros(7, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.fused_sgd_update(p, p, p, 100, 0.03, 0.9)
    x = torch.zeros(2, 3, 3, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.lrn_forward(x)
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.lrn_backward(x, x, x)
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.dropout(x, 3, 0.5)
    with pytest.raises(ValueError, match="no kernel for device"):
        HK.bernoulli(3, x)
    q = torch.zeros(1, 2, 8, 4, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    for call in (lambda: HK.flash_attention_fwd(q, q, q),
                 lambda: HK.flash_attention_bwd_dkv(q, q, q, q, lse, q),
                 lambda: HK.flash_attention_bwd_dq(q, q, q, q, lse, q)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()


def test_population_and_rolling_slice_is_checked(monkeypatch):
    """The worker pool, the genetic optimizer, the ensemble, their
    workers and the ZeroMQ loader are among the modules the two checks
    above import and parse; the GA and the ensemble run on the card
    unless the CPU is asked for, and raise without one."""
    assert {"veles_tpu_torch.subproc", "veles_tpu_torch.genetics",
            "veles_tpu_torch.genetics.eval_worker",
            "veles_tpu_torch.ensemble",
            "veles_tpu_torch.ensemble.train_worker",
            "veles_tpu_torch.zmq_loader"} <= set(_modules())
    from veles_tpu_torch.ensemble import train_ensemble
    from veles_tpu_torch.genetics import (evaluate_population,
                                          optimize_workflow)
    from veles_tpu_torch.samples import mnist
    from veles_tpu_torch import __main__ as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: optimize_workflow(mnist, 1, 2),
                 lambda: evaluate_population("m", [], [[0.5]], 1, 1),
                 lambda: train_ensemble(mnist, size=1),
                 lambda: cli.main(["veles_tpu_torch.samples.mnist",
                                   "--optimize", "1:2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_moe_module_is_checked():
    """The mixture-of-experts module is among those the two checks above
    import and parse."""
    assert "veles_tpu_torch.ops.moe" in set(_modules())


def test_pipeline_and_ring_modules_are_checked():
    """The GPipe and ring-attention modules are among those the two
    checks above import and parse."""
    assert {"veles_tpu_torch.parallel.pipeline",
            "veles_tpu_torch.parallel.ring"} <= set(_modules())


def test_parallel_slice_modules_are_checked(monkeypatch):
    """The data- and tensor-parallel module is among those the two
    checks above import and parse; importing it joins no run, and
    joining one without a card raises unless the CPU is asked for."""
    assert "veles_tpu_torch.parallel" in set(_modules())
    import torch.distributed as dist
    from veles_tpu_torch import parallel
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.initialize_multihost("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()
    assert set(parallel.collective_counts()) == {
        "grad_all_reduce", "metric_all_reduce", "tp_all_gather",
        "tp_input_grad_all_reduce", "ep_all_reduce",
        "ep_input_grad_all_reduce", "p2p_exchange",
        "stage_output_all_reduce", "stage_input_grad_all_reduce",
        "ring_all_gather", "ring_input_grad_all_reduce"}


def test_observability_modules_are_checked():
    """The plotters, the graphics transport, the web status, the Shell
    and publishing are among the modules the two checks above import and
    parse; importing them starts no server and imports no matplotlib."""
    names = set(_modules())
    assert {"veles_tpu_torch.plotter", "veles_tpu_torch.plotting_units",
            "veles_tpu_torch.nn_plotting_units",
            "veles_tpu_torch.graphics_server",
            "veles_tpu_torch.graphics_client",
            "veles_tpu_torch.web_status", "veles_tpu_torch.interaction",
            "veles_tpu_torch.publishing"} <= names
    code = ("import sys\n"
            "import veles_tpu_torch.plotting_units, "
            "veles_tpu_torch.nn_plotting_units, veles_tpu_torch.publishing, "
            "veles_tpu_torch.web_status, veles_tpu_torch.graphics_client\n"
            "print('MPL=%s' % ('matplotlib' in sys.modules))\n"
            "print('DEFAULT=%s' % veles_tpu_torch.web_status._default)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "MPL=False" in out.stdout and "DEFAULT=None" in out.stdout
