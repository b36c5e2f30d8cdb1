"""Directory-image-dataset sample: train a small conv net on a directory of
images, one class per subdirectory.

Ref: the reference's file-image sample pipelines (veles/loader/file_image.py
driven samples [M], SURVEY §2.2/§2.3): point the framework at a directory
tree and train — no dataset-specific code.  Uses
:class:`veles_tpu_torch.loader.image.AutoSplitImageLoader` (PIL decode,
scale, deterministic validation split) end to end.

Config (``root.image_dir``): ``loader.directory`` is required; the softmax
width follows the classes actually containing images, discovered at build
time.

Port of ``veles_tpu/samples/image_dir.py``; ``train`` runs on the CUDA
card unless the caller passes ``device="cpu"`` (with no card it raises).
"""

from __future__ import annotations

from veles_tpu_torch.config import root, get
from veles_tpu_torch.loader.image import AutoSplitImageLoader, scan_directory
from veles_tpu_torch.standard_workflow import StandardWorkflow


class ImageDirWorkflow(StandardWorkflow):
    """scale→conv→pool→conv→pool→FC over a scanned image directory."""


def default_config():
    root.image_dir.defaults({
        "loader": {"minibatch_size": 32, "scale": (32, 32),
                   "validation_ratio": 0.2, "color_space": "RGB"},
        "decision": {"max_epochs": 10, "fail_iterations": 20},
        # strict-relu convs with explicit init (see samples/mnist_conv.py)
        "layers": [
            {"type": "conv_str", "n_kernels": 16, "kx": 3, "ky": 3,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "conv_str", "n_kernels": 32, "kx": 3, "ky": 3,
             "padding": "SAME", "learning_rate": 0.02, "momentum": 0.9,
             "weights_filling": "gaussian", "weights_stddev": 0.05},
            {"type": "max_pooling", "kx": 2, "ky": 2},
            {"type": "softmax", "output_sample_shape": 2,
             "learning_rate": 0.02, "momentum": 0.9},
        ],
    })
    return root.image_dir


def _workflow_kwargs(loader_overrides=None, decision_overrides=None):
    """The one cfg→constructor-kwargs assembly (build and run share it,
    mirroring make_sample; hand-rolled only because the softmax width is
    discovered from the directory)."""
    cfg = default_config()
    loader_config = {k: get(v, v) for k, v in cfg.loader.items()}
    loader_config.update(loader_overrides or {})
    if "directory" not in loader_config:
        raise ValueError("image_dir sample needs loader.directory "
                         "(root.image_dir.loader.directory=PATH)")
    decision_config = {k: get(v, v) for k, v in cfg.decision.items()}
    decision_config.update(decision_overrides or {})
    layers = [dict(layer) for layer in get(cfg.layers, cfg.layers)]
    # count only classes that actually CONTAIN images — the loader derives
    # its label map the same way, so the widths always agree
    _, names = scan_directory(loader_config["directory"])
    layers[-1]["output_sample_shape"] = max(2, len(set(names)))
    kwargs = dict(name="image_dir", loader_factory=AutoSplitImageLoader,
                  loader_config=loader_config, layers=layers,
                  decision_config=decision_config, loss_function="softmax")
    if "snapshotter" in cfg:
        kwargs["snapshotter_config"] = {
            k: get(v, v) for k, v in cfg.snapshotter.items()}
    return kwargs


def build(fused=True, **overrides):
    kwargs = _workflow_kwargs(overrides.pop("loader", None),
                              overrides.pop("decision", None))
    kwargs.update(overrides)  # layers / loss_function / name override clean
    return ImageDirWorkflow(None, fused=fused, **kwargs)


def train(fused=True, device=None, **overrides):
    """Build, initialize on ``device`` (None = the CUDA card) and run
    to completion; returns the workflow."""
    wf = build(fused=fused, **overrides)
    wf.initialize(device=device)
    wf.run()
    return wf


def run(load, main):
    load(ImageDirWorkflow, **_workflow_kwargs())
    main()
