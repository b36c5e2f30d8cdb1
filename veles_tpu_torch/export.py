"""Framework-independent inference artifacts.

Port of ``veles_tpu/export.py``.  The trained eval forward is captured
with ``torch.export`` as a pure function of ``(*params, x)`` with a
dynamic batch dimension, bundled with the weights and a manifest into
one file.  Loading it needs torch, numpy and the port's kernel module
(for the LRN op, below) — no units, loaders or workflow — and the same
bytes run on the CPU or the card: :func:`load_model` moves the program
to the device it is asked for.

Artifact layout (tar.gz, its deflate blocks stored: float weights
barely compress — 7% at any level — while zlib runs at ~20 MB/s, so a
full-width AlexNet would spend ~15 s in it on every export and ~4 s on
every load):
    manifest.json     input/output specs, sample metadata, format version
    model.pt2         ``torch.export.save`` bytes (forward: (*params, x))
    weights.npz       flattened parameter arrays, insertion-ordered

The LRN forward stays one node of the program, the op
``veles_tpu_torch::lrn_forward`` (``ops/hopper_kernels.py``): on the
card a loaded program launches the hand-written kernel through it,
counted as every launch is.

:func:`export_native_bundle` compiles the forward with AOTInductor, the
weights baked in and the batch static, for the native runner
(``native/artifact_runner.cpp``).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
import time

import numpy
import torch

MANIFEST = "manifest.json"
MODEL = "model.pt2"
WEIGHTS = "weights.npz"
#: artifact format versions this loader understands; quantized bundles
#: are stamped 2 so pre-quantization deployments reject them with a
#: clear unsupported-format error instead of a dtype crash at predict
FORMAT = 1
FORMAT_QUANTIZED = 2
KNOWN_FORMATS = (FORMAT, FORMAT_QUANTIZED)

#: devices every artifact runs on
PLATFORMS = ("cpu", "cuda")


def _flatten_state(state):
    """Runner state (list of per-layer dicts) -> ordered {key: tensor}."""
    flat = {}
    for i, entry in enumerate(state):
        for k in sorted(entry):
            flat["%d/%s" % (i, k)] = entry[k]
    return flat


def _quantize_int8(flat):
    """Symmetric per-output-channel int8 weight quantization: each
    ``<layer>/w`` array is stored as an int8 array plus a float32
    ``<layer>/w.scale`` vector over the last (output) axis; biases and
    1-D params stay float32.  Purely a storage format (~4x smaller
    artifacts): :func:`load_model` dequantizes once, so the program and
    the per-call serving cost are those of fp32."""
    out = {}
    for key, arr in flat.items():
        if key.endswith("/w") and arr.ndim >= 2:
            scale = numpy.abs(arr).max(
                axis=tuple(range(arr.ndim - 1)))
            scale = numpy.maximum(scale / 127.0, 1e-12).astype(
                numpy.float32)
            out[key] = numpy.clip(numpy.rint(arr / scale), -127,
                                  127).astype(numpy.int8)
            out[key + ".scale"] = scale
        else:
            out[key] = arr
    return out


def _runner_of(workflow, what):
    runner = getattr(workflow, "_fused_runner", None)
    if runner is None:
        raise ValueError("%s needs a fused workflow "
                         "(StandardWorkflow(..., fused=True))" % what)
    # inference does not need optimizer state (velocities, solver
    # accumulators) — weights and biases only
    state = [{k: v for k, v in entry.items() if k in ("w", "b")}
             for entry in runner.state]
    return runner, state


def _rebuild(keys, n_layers, arrays):
    rebuilt = [dict() for _ in range(n_layers)]
    for key, value in zip(keys, arrays):
        layer, name = key.split("/", 1)
        rebuilt[int(layer)][name] = value
    return rebuilt


class _Forward(torch.nn.Module):
    """``forward(*params, x)``: the runner's eval forward over a state
    rebuilt from the flat parameters."""

    def __init__(self, runner, keys, n_layers):
        super().__init__()
        self._runner, self._keys, self._n = runner, keys, n_layers

    def forward(self, *args):
        state = _rebuild(self._keys, self._n, args[:-1])
        acts, _ = self._runner._forward_chain(state, args[-1], rng=None,
                                              train=False)
        return acts[-1]


class _BakedForward(torch.nn.Module):
    """``forward(x)`` with the parameters held as buffers (constants of
    a compiled program)."""

    def __init__(self, runner, flat, n_layers):
        super().__init__()
        self._runner, self._keys, self._n = runner, list(flat), n_layers
        for i, value in enumerate(flat.values()):
            self.register_buffer("p%d" % i, value.detach().clone())

    def forward(self, x):
        state = _rebuild(self._keys, self._n,
                         [getattr(self, "p%d" % i)
                          for i in range(len(self._keys))])
        acts, _ = self._runner._forward_chain(state, x, rng=None,
                                              train=False)
        return acts[-1]


def _sample_shape(workflow):
    return tuple(workflow.loader.minibatch_data.shape[1:])


def _out_val(program):
    """The program's one output, as its fake tensor."""
    node = next(n for n in program.graph.nodes if n.op == "output")
    return node.args[0][0].meta["val"]


def export_model(workflow, path, metadata=None, quantize=None):
    """Export a trained (fused) workflow's eval forward as an artifact.

    The forward is traced as a function of (params..., x) with a
    dynamic batch dimension, on the workflow's device, so the artifact
    serves any batch size.  ``quantize="int8"`` ships weights as
    per-channel int8 (see :func:`_quantize_int8`)."""
    if quantize not in (None, "int8"):
        raise ValueError("unknown quantize mode %r" % (quantize,))
    runner, state = _runner_of(workflow, "export_model")
    flat = _flatten_state(state)
    keys = list(flat)
    host = {k: v.detach().cpu().numpy() for k, v in flat.items()}
    store = _quantize_int8(host) if quantize == "int8" else host
    sample_shape = _sample_shape(workflow)
    # an example batch of 2: a traced batch of 1 would be specialized
    x = torch.zeros((2,) + sample_shape, dtype=torch.float32,
                    device=next(iter(flat.values())).device)
    batch = torch.export.Dim("batch")
    program = torch.export.export(
        _Forward(runner, keys, len(state)), tuple(flat.values()) + (x,),
        dynamic_shapes=((None,) * len(keys) + ({0: batch},),))
    out = _out_val(program)

    import veles_tpu_torch
    manifest = {
        "format": FORMAT_QUANTIZED if quantize else FORMAT,
        "framework_version": veles_tpu_torch.__version__,
        "name": workflow.name,
        "input_sample_shape": list(sample_shape),
        "input_dtype": "float32",
        "output_sample_shape": [int(d) for d in out.shape[1:]],
        "output_dtype": str(out.dtype).replace("torch.", ""),
        "param_keys": keys,
        "quantize": quantize,
        "platforms": list(PLATFORMS),
        "exported_at": time.time(),
        "metadata": metadata or {},
    }
    # the example inputs would store every weight a second time
    program.example_inputs = None
    program_bytes = io.BytesIO()
    torch.export.save(program, program_bytes)
    with tarfile.open(path, "w:gz", compresslevel=0) as tar:
        def add_bytes(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        add_bytes(MANIFEST, json.dumps(manifest, indent=2).encode("utf-8"))
        add_bytes(MODEL, program_bytes.getvalue())
        buf = io.BytesIO()
        numpy.savez(buf, **store)
        add_bytes(WEIGHTS, buf.getvalue())
    return path


class ExportedModel:
    """A loaded artifact: ``predict(x)`` with no framework around it (no
    units, loaders or workflow graph)."""

    def __init__(self, manifest, program, params, device):
        self.manifest = manifest
        self.device = device
        self._program = program
        self._module = program.module()
        #: the parameters as fp32 numpy arrays (int8 ones dequantized)
        self._params = params
        self._tensors = [torch.from_numpy(p).to(device) for p in params]

    @property
    def name(self):
        return self.manifest.get("name")

    def predict(self, x):
        """numpy (b, *sample) -> numpy (b, *output sample), computed on
        :attr:`device`."""
        x = numpy.ascontiguousarray(x, numpy.float32)
        sample_shape = tuple(self.manifest["input_sample_shape"])
        if x.shape[1:] != sample_shape:
            x = x.reshape((len(x),) + sample_shape)
        with torch.no_grad():
            out = self._module(*self._tensors,
                               torch.from_numpy(x).to(self.device))
        return out.cpu().numpy()


def load_model(path, device=None):
    """Load an artifact file into an :class:`ExportedModel` on
    ``device`` (None: the CUDA card, raising without one).

    The program's products run in full fp32, as the port's default
    ('float32') precision mode runs them: loading pins cuBLAS and cuDNN
    to fp32 (TF32 off) for the process, as a workflow's initialize
    does."""
    from veles_tpu_torch.device import resolve_device
    from veles_tpu_torch.ops.functional import pin_fp32_matmul
    # the program names the LRN op: its module registers it
    from veles_tpu_torch.ops import hopper_kernels  # noqa: F401
    device = resolve_device(device)
    pin_fp32_matmul()
    with tarfile.open(path, "r:gz") as tar:
        def read(name):
            member = tar.extractfile(name)
            if member is None:
                raise ValueError("%s has no %s" % (path, name))
            return member.read()

        manifest = json.loads(read(MANIFEST))
        if manifest.get("format") not in KNOWN_FORMATS:
            raise ValueError("unsupported artifact format %r"
                             % manifest.get("format"))
        program = torch.export.load(io.BytesIO(read(MODEL)))
        npz = numpy.load(io.BytesIO(read(WEIGHTS)))
        params = []
        for k in manifest["param_keys"]:
            arr = npz[k]
            if arr.dtype == numpy.int8:   # int8 storage: dequantize ONCE
                arr = npz[k + ".scale"] * arr.astype(numpy.float32)
            params.append(arr)
    from torch.export.passes import move_to_device_pass
    program = move_to_device_pass(program, str(device))
    return ExportedModel(manifest, program, params, device)


def _openmp_cxx():
    """A C++ compiler that finds its ``libgomp.spec`` (Inductor links the
    package's wrapper with ``-fopenmp``): the first of ``$CXX``, ``g++``
    on the PATH and ``/usr/bin/g++`` that does; None keeps Inductor's
    own choice."""
    import shutil
    import subprocess
    for cxx in (os.environ.get("CXX"), "g++", "/usr/bin/g++"):
        path = cxx and shutil.which(cxx)
        if not path:
            continue
        spec = subprocess.run([path, "-print-file-name=libgomp.spec"],
                              capture_output=True, text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return path
    return None


def export_native_bundle(workflow, out_dir, batch=8):
    """Export the eval forward as a native bundle for the libtorch
    runner (``native/artifact_runner.cpp``), compiled for the device
    the workflow was initialized on:

    - ``program.pt2`` — an AOTInductor package, the trained weights
      baked in as constants and the batch static, so the runner needs
      no weight files and no Python;
    - ``input.shape`` — ascii dims sidecar the runner reads;
    - ``manifest.json`` — shapes, dtypes and the device, for humans and
      tooling.
    """
    device = workflow.device
    runner, state = _runner_of(workflow, "export_native_bundle")
    flat = {k: v.to(device) for k, v in _flatten_state(state).items()}
    in_shape = (int(batch),) + _sample_shape(workflow)
    x = torch.zeros(in_shape, dtype=torch.float32, device=device)
    program = torch.export.export(_BakedForward(runner, flat, len(state)),
                                  (x,))
    out = _out_val(program)
    os.makedirs(out_dir, exist_ok=True)
    # AOTInductor's conv layout optimization miscompiles a program with
    # baked weights on the card when a conv reads a sliced (cropped)
    # NHWC input and is followed by a relu, or takes its weight as
    # permuted HWIO: plain torch modules of that shape, none of the
    # port's code in them, under the port's backend flags (TF32 off,
    # cuDNN deterministic), come out 0.45-0.76 off in softmax
    # probabilities, while torch.compile and the package with the
    # optimization off agree with eager to ~1e-7
    # (``tools/aoti_layout_repro.py``, variants crop_relu and crop_hwio).
    # AlexNet's eval forward is a center crop, then conv + relu.
    config = {"layout_optimization": False}
    if device.type == "cuda":
        # The host side of a card bundle only launches kernels, so it
        # needs no SIMD: Inductor's probe of the host CPU's vector ISA
        # (test programs compiled under a file lock) and its pool of
        # compile workers cost most of a bundle's compile on an H100
        # host with no Inductor cache (``chip_smoke.py`` phase 15
        # reports ``aoti_compile_s``).
        config.update({"cpp.vec_isa_ok": False, "compile_threads": 1})
    cxx = _openmp_cxx()
    if cxx:
        config["cpp.cxx"] = (None, cxx)
    with torch._inductor.config.patch(config):
        torch._inductor.aoti_compile_and_package(
            program, package_path=os.path.join(out_dir, "program.pt2"))

    import veles_tpu_torch
    with open(os.path.join(out_dir, "input.shape"), "w",
              encoding="utf-8") as f:
        f.write(" ".join(str(d) for d in in_shape))
    with open(os.path.join(out_dir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump({
            "name": workflow.name,
            "framework_version": veles_tpu_torch.__version__,
            "input_shape": list(in_shape),
            "input_dtype": "float32",
            "output_shape": [int(d) for d in out.shape],
            "output_dtype": str(out.dtype).replace("torch.", ""),
            "device": device.type,
            "exported_at": time.time(),
        }, f, indent=2)
    return out_dir
