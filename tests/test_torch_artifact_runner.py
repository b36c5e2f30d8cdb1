"""The native artifact runner (``veles_tpu_torch/native/artifact_runner.cpp``)
on the CPU: the narrow LRN net of ``tests/test_torch_export.py`` exported
with ``export.export_native_bundle`` (AOTInductor, batch 8, weights
baked in), run by the runner built with g++ against the installed
torch, and held to the exported artifact's ``predict`` on the same rows
within 1e-5 (AOTInductor's generated CPU code may fuse and order the
pointwise work differently from ATen's eager kernels).

The runner registers ``veles_tpu_torch::lrn_forward`` itself, under the
Python op's schema; a runner built from the source with the
registration taken out must exit non-zero naming the op.  The bundle
compile (~20 s) and the two runner builds (~15 s each) take most of
this file's ~50 s on a CPU.
"""

import json
import re
import shutil
import subprocess

import numpy
import pytest
import torch

from test_torch_export import lrn_net
from veles_tpu_torch import export, native
from veles_tpu_torch.ops import hopper_kernels as HK

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the runner builds with g++")

SCHEMA = re.compile(r'm\.def\("(lrn_forward\(.*?)"\s*"(.*?)"\);', re.S)
#: the op registration blocks of the runner's source
REGISTRATION = re.compile(r"TORCH_LIBRARY\(veles_tpu_torch.*?\n}\n\n"
                          r"TORCH_LIBRARY_IMPL\(veles_tpu_torch, CPU.*?\n}\n",
                          re.S)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        wf = lrn_net()
        out = tmp_path_factory.mktemp("runner")
        export.export_native_bundle(wf, str(out / "bundle"), batch=8)
        export.export_model(wf, str(out / "lrn.veles"))
        model = export.load_model(str(out / "lrn.veles"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    return out, model


def test_runner_matches_predict(bundle):
    out, model = bundle
    manifest = json.loads((out / "bundle" / "manifest.json").read_text())
    assert manifest["input_shape"] == [8, 16, 16, 3]
    assert manifest["output_shape"] == [8, 4]
    assert manifest["device"] == "cpu"
    assert (out / "bundle" / "input.shape").read_text() == "8 16 16 3"
    x = numpy.random.RandomState(11).uniform(0, 1, (8, 16, 16, 3)).astype(
        numpy.float32)
    got, launches, stdout, _ = native.run_artifact(out / "bundle", x)
    want = model.predict(x)
    numpy.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    numpy.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    # the CPU runs the op's plain window sum: no kernel launch
    assert launches == 0 and "EXECUTE OK" in stdout
    assert str(native.build_runner()).startswith(str(native.BUILD_DIR))


def test_runner_schema_is_the_python_ops():
    text = native.RUNNER_SOURCE.read_text()
    (head, tail), = SCHEMA.findall(text)
    schema = str(torch.ops.veles_tpu_torch.lrn_forward.default._schema)
    assert "veles_tpu_torch::" + head + tail == schema
    assert HK.LRN_FORWARD_OP == "veles_tpu_torch::lrn_forward"


def test_selfcheck_and_usage():
    runner = str(native.build_runner())
    proc = subprocess.run([runner, "--selfcheck"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "SELFCHECK OK" in proc.stdout
    assert "veles_tpu_torch::lrn_forward(Tensor x" in proc.stdout
    assert "libtorch %s" % torch.__version__.split("+")[0] in proc.stdout
    proc = subprocess.run([runner], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2 and "usage" in proc.stderr


def test_unregistered_op_fails_naming_it(bundle, tmp_path):
    out, _ = bundle
    text = native.RUNNER_SOURCE.read_text()
    stripped, n = REGISTRATION.subn("", text)
    assert n == 1
    source = tmp_path / "artifact_runner.cpp"
    source.write_text(stripped)
    runner = native.build_runner(source)
    assert runner != native.build_runner()
    x = numpy.zeros((8, 16, 16, 3), numpy.float32)
    with pytest.raises(RuntimeError) as err:
        native.run_artifact(out / "bundle", x, runner=runner)
    assert "veles_tpu_torch::lrn_forward" in str(err.value)
    assert "exited 1" in str(err.value)


def test_run_artifact_checks_the_input_shape(bundle):
    out, _ = bundle
    with pytest.raises(ValueError, match="the bundle takes"):
        native.run_artifact(out / "bundle",
                            numpy.zeros((4, 16, 16, 3), numpy.float32))
