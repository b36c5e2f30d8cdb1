"""Whether AOTInductor's conv layout optimization changes what a
conv → FC → softmax program computes when its weights are baked in as
constants.  Some variants are plain torch, some run the port's code,
each under torch's default backend flags or under the port's, to tell a
fault of the compiler from one of the port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 -m veles_tpu_torch.tools.aoti_layout_repro \
        [--variants NAME ...] [--flags torch port]

Each variant is a ``torch.nn.Module`` whose weights are buffers (the
constants of the compiled package, as ``export.export_native_bundle``
bakes them), exported with ``torch.export`` at a static batch and
compiled with ``torch._inductor.aoti_compile_and_package`` twice:
Inductor's ``layout_optimization`` on (its default) and off.  Prints one
JSON line per variant and flag set: the largest gap of each package's
output, and of ``torch.compile``'s, from the eager forward on the same
seeded input.

Flag sets (``FLAGS``): ``torch`` is torch's defaults (cuDNN may use
TF32, nondeterministic algorithms allowed); ``port`` is what a
workflow's ``initialize`` sets in the port's default precision mode
(``ops.functional.set_matmul_precision("float32")``: TF32 off in cuDNN
and cuBLAS, cuDNN's deterministic algorithms).

Plain torch (``VARIANTS``), a 3 x 3 conv of 8 kernels on 16 x 16 x 3
unless said otherwise:

- ``bare``: NCHW input, ``F.conv2d`` with an OIHW weight and its bias,
  flatten (in NCHW order: another function than the rest compute), a
  matmul, ``softmax``;
- ``nhwc``: the same on an NHWC input: permuted to NCHW for the conv and
  back after it, the bias added in NHWC, ``contiguous`` before the
  flatten (the port's layout, written out with plain torch);
- ``crop_nhwc``: ``nhwc`` behind the center crop of a 32 x 32 input to
  28 x 28 (a slice, then ``contiguous``), the conv 5 x 5 at stride 2;
- ``crop_relu``: ``crop_nhwc`` with ``clamp_min(z, 0)`` after the bias;
- ``crop_hwio``: ``crop_nhwc`` with an HWIO weight buffer, made OIHW in
  channels_last memory in the forward
  (``permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)``, as the
  port's ``ops.functional._oihw`` does);
- ``crop_hwio_relu``: both;
- ``bare_conv1`` (only when named): ``bare`` at AlexNet's first conv
  (227 x 227 x 3, 11 x 11 stride 4, 96 kernels) into a 10-way FC.

The port's code:

- ``port``: ``ops.functional.conv2d_preact`` on HWIO weights, then the
  FC and softmax of ``bare``;
- ``chain``, ``chain_crop``, ``chain_trained`` (``CHAINS``): the port's
  fused eval forward of an ``imagenet`` sample workflow, its weights
  baked in as ``export.export_native_bundle`` bakes them: ``conv_str``
  → ``softmax``; the same behind ``random_crop_flip`` as ``crop_nhwc``;
  that workflow after one epoch of training (2 steps).

Then the card's name and power limit, and last the torch version.
"""

import argparse
import json
import os
import subprocess
import tempfile

import numpy
import torch
import torch.nn.functional as F

from veles_tpu_torch.export import _openmp_cxx


class _Net(torch.nn.Module):
    """conv → FC → softmax, the weights held as buffers."""

    def __init__(self, kind, w, b, fc_w, fc_b, stride, pad):
        super().__init__()
        self.kind, self.stride, self.pad = kind, stride, pad
        self.crop, self.hwio = "crop" in kind, "hwio" in kind
        self.relu = "relu" in kind
        for name, value in (("w", w), ("b", b), ("fc_w", fc_w),
                            ("fc_b", fc_b)):
            self.register_buffer(name, value)

    def forward(self, x):
        if self.kind == "port":
            from veles_tpu_torch.ops import functional
            z = functional.conv2d_preact(x, self.w, self.b,
                                         (self.stride,) * 2, "SAME")
        elif self.kind != "bare":
            if self.crop:
                x = x[:, 2:30, 2:30].contiguous()
            w = self.w
            if self.hwio:
                w = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            z = F.conv2d(x.permute(0, 3, 1, 2), w, None, self.stride,
                         self.pad)
            z = z.permute(0, 2, 3, 1) + self.b
            if self.relu:
                z = torch.clamp_min(z, 0.0)
            z = z.contiguous()
        else:
            z = F.conv2d(x, self.w, self.b, self.stride, self.pad)
        z = z.reshape(z.shape[0], -1)
        return torch.softmax(z @ self.fc_w + self.fc_b, dim=-1)


#: name: (kind, NHWC input shape, kernel, out channels, stride, pad,
#: classes)
VARIANTS = {
    "bare": ("bare", (8, 16, 16, 3), 3, 8, 1, 1, 4),
    "nhwc": ("nhwc", (8, 16, 16, 3), 3, 8, 1, 1, 4),
    "crop_nhwc": ("crop_nhwc", (8, 32, 32, 3), 5, 8, 2, 0, 4),
    "crop_relu": ("crop_relu", (8, 32, 32, 3), 5, 8, 2, 0, 4),
    "crop_hwio": ("crop_hwio", (8, 32, 32, 3), 5, 8, 2, 0, 4),
    "crop_hwio_relu": ("crop_hwio_relu", (8, 32, 32, 3), 5, 8, 2, 0, 4),
    "port": ("port", (8, 16, 16, 3), 3, 8, 1, 1, 4),
    "bare_conv1": ("bare", (8, 227, 227, 3), 11, 96, 4, 0, 10),
}

#: name: (NHWC input shape, center crop or None, kernel, stride,
#: padding, train steps)
CHAINS = {
    "chain": ((8, 16, 16, 3), None, 3, 1, "SAME", 0),
    "chain_crop": ((8, 32, 32, 3), 28, 5, 2, "VALID", 0),
    "chain_trained": ((8, 32, 32, 3), 28, 5, 2, "VALID", 2),
}


def _torch_flags():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False


def _port_flags():
    from veles_tpu_torch.ops import functional
    functional.set_matmul_precision("float32")


FLAGS = {"torch": _torch_flags, "port": _port_flags}


def _chain(name, device):
    """The port's baked eval forward of a ``CHAINS`` workflow."""
    from veles_tpu_torch import export, prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import imagenet
    shape, crop, k, stride, padding, steps = CHAINS[name]
    prng.reset()
    prng.seed_all(0)
    n, h, w, _ = shape
    layers = [] if crop is None else [
        {"type": "random_crop_flip", "crop": [crop, crop]}]
    layers += [{"type": "conv_str", "n_kernels": 8, "kx": k, "ky": k,
                "sliding": (stride, stride), "padding": padding},
               {"type": "softmax", "output_sample_shape": 4}]
    root.imagenet.update({
        "loader": {"minibatch_size": n, "records_path": None,
                   "n_train": max(steps, 1) * n, "n_valid": n,
                   "image_hw": (h, w), "n_classes": 4},
        "decision": {"max_epochs": 1, "fail_iterations": 5},
        "layers": layers})
    if steps:
        wf = imagenet.train(fused=True, device=device)
    else:
        wf = imagenet.build(fused=True)
        wf.initialize(device=device)
    runner, state = export._runner_of(wf, "aoti_layout_repro")
    return export._BakedForward(runner, export._flatten_state(state),
                                len(state))


def build(name, device, seed=0):
    """(module, input) of a variant, from the seed."""
    rng = numpy.random.RandomState(seed)

    def t(*dims, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*dims))
                                .astype(numpy.float32)).to(device)

    if name in CHAINS:
        return _chain(name, device), t(*CHAINS[name][0])
    kind, shape, k, cout, stride, pad, classes = VARIANTS[name]
    n, h, w_, cin = shape
    if kind.startswith("crop"):
        h = w_ = 28
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w_ + 2 * pad - k) // stride + 1
    fan = k * k * cin
    hwio = t(k, k, cin, cout, scale=fan ** -0.5)
    w = (hwio if kind == "port" or "hwio" in kind
         else hwio.permute(3, 2, 0, 1).contiguous())
    net = _Net(kind, w, t(cout, scale=0.1),
               t(oh * ow * cout, classes, scale=(oh * ow * cout) ** -0.5),
               t(classes, scale=0.1), stride, pad)
    x = t(*shape)
    if kind == "bare":
        x = x.permute(0, 3, 1, 2).contiguous()
    return net, x


def gaps(name, flags, device, tmp):
    """{way: max abs gap from eager} of one variant under one flag set."""
    net, x = build(name, device)
    FLAGS[flags]()
    with torch.no_grad():
        want = net(x)
        out = {"torch_compile": (torch.compile(net)(x) - want).abs().max()
               .item()}
    program = torch.export.export(net, (x,))
    for layout in (True, False):
        path = os.path.join(tmp, "%s_%s_%d.pt2" % (name, flags, layout))
        config = {"layout_optimization": layout}
        cxx = _openmp_cxx()
        if cxx:
            config["cpp.cxx"] = (None, cxx)
        with torch._inductor.config.patch(config):
            torch._inductor.aoti_compile_and_package(program,
                                                     package_path=path)
        got = torch._inductor.aoti_load_package(path)(x)
        got = got[0] if isinstance(got, (list, tuple)) else got
        key = "aoti_layout_%s" % ("on" if layout else "off")
        out[key] = (got - want).abs().max().item()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variants", nargs="*",
                        default=[v for v in list(VARIANTS) + list(CHAINS)
                                 if v != "bare_conv1"])
    parser.add_argument("--flags", nargs="*", default=list(FLAGS))
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        for flags in args.flags:
            for name in args.variants:
                print(json.dumps({
                    "variant": name, "flags": flags,
                    "max_abs_gap_from_eager": gaps(name, flags, "cuda",
                                                   tmp)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__}))


if __name__ == "__main__":
    main()
