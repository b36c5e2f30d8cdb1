"""Sample launchers — the model zoo (ref: veles/znicz/samples/** [H]).

Port of ``veles_tpu/samples/__init__.py``.  Each sample module defines a
Workflow subclass plus a ``run(load, main)`` entry point, and direct
``build(...)``/``train(...)`` helpers; the shared config→workflow wiring
lives in :func:`make_sample`.  Every entry point runs on the CUDA card
unless the caller passes ``device="cpu"`` (with no card it raises).
"""

from veles_tpu_torch.config import root, get


def run_sample(module, seed=None, build_kwargs=None, device=None):
    """Drive one sample's ``run(load, main)`` to completion and return the
    trained workflow: optional full PRNG reseed, then build + initialize
    (on ``device``) + run."""
    from veles_tpu_torch import prng
    if seed is not None:
        prng.reset()
        prng.seed_all(seed)
    holder = {}

    def load(workflow_cls, **kwargs):
        kwargs.update(build_kwargs or {})
        wf = workflow_cls(None, **kwargs)
        holder["wf"] = wf
        return wf

    def main():
        holder["wf"].initialize(device=device)
        holder["wf"].run()

    module.run(load, main)
    return holder["wf"]


def make_sample(config_name, workflow_cls, loader_cls, default_config,
                loss_function="softmax"):
    """Standard sample scaffolding: returns (build, train, run).

    ``config_name`` is the node under the port's ``root`` (e.g.
    "mnist"); ``default_config()`` installs defaults (with defaults()
    semantics so user config set beforehand wins).
    """

    def _config():
        cfg = getattr(root, config_name)
        if "layers" not in cfg:
            default_config()
            cfg = getattr(root, config_name)
        return cfg

    def _workflow_kwargs():
        """The ONE cfg→constructor-kwargs assembly (build and run share it)."""
        cfg = _config()
        kwargs = dict(
            name=config_name,
            loader_factory=loader_cls,
            loader_config={k: get(v, v) for k, v in cfg.loader.items()},
            layers=get(cfg.layers, cfg.layers),
            decision_config={k: get(v, v) for k, v in cfg.decision.items()},
            loss_function=loss_function)
        if "snapshotter" in cfg:
            kwargs["snapshotter_config"] = {
                k: get(v, v) for k, v in cfg.snapshotter.items()}
        if "grad_accum" in cfg:
            kwargs["grad_accum"] = int(get(cfg.grad_accum,
                                           cfg.grad_accum))
        return kwargs

    def build(fused=True, **overrides):
        kwargs = _workflow_kwargs()
        kwargs["loader_config"].update(overrides.pop("loader", {}))
        kwargs["decision_config"].update(overrides.pop("decision", {}))
        kwargs.update(overrides)
        return workflow_cls(None, fused=fused, **kwargs)

    def train(fused=True, device=None, **overrides):
        """Build, initialize on ``device`` (None = the CUDA card) and run
        to completion; returns the workflow."""
        wf = build(fused=fused, **overrides)
        wf.initialize(device=device)
        wf.run()
        return wf

    def run(load, main):
        load(workflow_cls, **_workflow_kwargs())
        main()

    return build, train, run


def make_trainer_sample(config_name, workflow_cls, default_config,
                        sections=("loader", "trainer", "decision")):
    """Scaffolding for non-StandardWorkflow samples (the Kohonen SOM, the
    MNIST RBM, the char LM): the workflow constructor takes one
    ``<section>_config`` dict per section.  Returns (build, train, run); ``train(device=None, ...)``
    runs on the CUDA card unless the caller passes ``device="cpu"``."""

    def _workflow_kwargs():
        default_config()
        cfg = getattr(root, config_name)
        kwargs = {"name": config_name}
        for section in sections:
            kwargs["%s_config" % section] = {
                k: get(v, v) for k, v in getattr(cfg, section).items()}
        return kwargs

    def build(**overrides):
        kwargs = _workflow_kwargs()
        for section in sections:
            kwargs["%s_config" % section].update(
                overrides.pop(section, {}))
        kwargs.update(overrides)
        return workflow_cls(None, **kwargs)

    def train(device=None, **overrides):
        """Build, initialize on ``device`` (None = the CUDA card) and run
        to completion; returns the workflow."""
        wf = build(**overrides)
        wf.initialize(device=device)
        wf.run()
        return wf

    def run(load, main):
        load(workflow_cls, **_workflow_kwargs())
        main()

    return build, train, run
