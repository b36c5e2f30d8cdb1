"""The port's report publishing (``publishing``) against the JAX package
on the CPU.

What is held, and how closely:

- the same facts render to the same Markdown, HTML, JSON and Confluence
  text in both packages (exactly: the facts carry ``generated_at``), and
  to PDFs with the same number of pages;
- ``gather`` of the same seeded tiny MNIST run in both packages gives
  the same facts apart from ``generated_at`` and ``run_seconds``: the
  epochs' ``n_err``, ``count`` and ``err_pct`` equal, the losses within
  1e-5 (the MNIST-FC tolerance, ``tests/test_torch_mnist.py``);
- ``Publisher`` writes one file a backend, its JSON epochs equal to the
  decision's ``epoch_metrics``; ``publish_confluence`` sends the same
  request as the reference's to a local stand-in server.
"""

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from veles_tpu import publishing as ref_pub
from veles_tpu_torch import prng
from veles_tpu_torch import publishing as pub
from veles_tpu_torch.config import root

SMALL = {"loader": {"minibatch_size": 50, "n_train": 230, "n_valid": 70},
         "decision": {"max_epochs": 2, "fail_iterations": 50},
         "layers": [{"type": "all2all_tanh", "output_sample_shape": 16,
                     "learning_rate": 0.03, "momentum": 0.9},
                    {"type": "softmax", "output_sample_shape": 10,
                     "learning_rate": 0.03, "momentum": 0.9}]}


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(cfg_root):
    cfg_root.__dict__.pop("mnist", None)
    cfg_root.mnist.update({k: dict(v) if isinstance(v, dict) else list(v)
                           for k, v in SMALL.items()})


@pytest.fixture(scope="module")
def runs():
    """(port workflow, reference workflow) of the same seeded run."""
    from veles_tpu import prng as jax_prng
    from veles_tpu.config import root as jax_root
    from veles_tpu.samples import mnist as jax_mnist
    from veles_tpu_torch.samples import mnist
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prng.reset()
        prng.seed_all(5)
        _config(root)
        ours = mnist.train(fused=True, device="cpu")
    finally:
        root.__dict__.pop("mnist", None)
        torch.set_num_threads(threads)
    saved = jax_root.__dict__.pop("mnist", None)
    try:
        jax_prng.reset()
        jax_prng.seed_all(5)
        _config(jax_root)
        theirs = jax_mnist.train(fused=True)
    finally:
        jax_root.__dict__.pop("mnist", None)
        if saved is not None:
            jax_root.__dict__["mnist"] = saved
        jax_prng.reset()
    return ours, theirs


def _facts(plots=(), epochs=True, run_seconds=12.5):
    facts = {
        "workflow": "mnist <&>", "workflow_class": "MnistWorkflow",
        "generated_at": "2026-10-18 12:00:00", "run_seconds": run_seconds,
        "best_metric": 3, "best_epoch": 2, "epochs": [],
        "units": ["start_point", "loader", "decision & co"],
        "plots": list(plots)}
    if epochs:
        facts["epochs"] = [
            {"epoch": 1, "validation_n_err": 9, "validation_loss": 0.5,
             "train_err_pct": 12.25},
            {"epoch": 2, "validation_n_err": 3, "validation_loss": 0.125,
             "train_err_pct": 1.0 / 3.0, "test_note": "a<b"}]
    return facts


FACT_CASES = {"full": {}, "no_epochs": {"epochs": False},
              "no_run_seconds": {"run_seconds": None}}


@pytest.mark.parametrize("backend", ["markdown", "html", "json",
                                     "confluence"])
@pytest.mark.parametrize("case", sorted(FACT_CASES))
def test_text_renders_equal_the_reference(backend, case, tmp_path):
    plot = tmp_path / "p.png"
    plot.write_bytes(b"\x89PNG fake bytes")
    facts = _facts(plots=[str(plot), str(tmp_path / "missing.png")],
                   **FACT_CASES[case])
    ours = pub.BACKENDS[backend]().render(json.loads(json.dumps(facts)))
    theirs = ref_pub.BACKENDS[backend]().render(json.loads(json.dumps(
        facts)))
    assert ours == theirs and ours
    if backend == "html":
        assert base64.b64encode(plot.read_bytes()).decode() in ours


def _pages(pdf):
    return len(re.findall(rb"/Type\s*/Page\b", pdf))


@pytest.mark.parametrize("epochs", [True, False])
def test_pdf_page_count_equals_the_reference(epochs):
    facts = _facts(epochs=epochs)
    ours = pub.PDFBackend().render(dict(facts))
    theirs = ref_pub.PDFBackend().render(dict(facts))
    assert ours.startswith(b"%PDF")
    assert _pages(ours) == _pages(theirs) == (2 if epochs else 1)


def test_gather_equals_the_reference(runs):
    ours, theirs = (mod.gather(wf) for mod, wf in zip((pub, ref_pub),
                                                       runs))
    for facts in (ours, theirs):
        facts.pop("generated_at")
    e_ours, e_theirs = ours.pop("epochs"), theirs.pop("epochs")
    assert ours == theirs
    assert len(e_ours) == len(e_theirs) == 2
    for a, b in zip(e_ours, e_theirs):
        assert list(a) == list(b)
        for key, value in a.items():
            if key.endswith("_loss"):
                assert abs(value - b[key]) < 1e-5
            else:
                assert value == b[key], key


def test_publisher_writes_a_file_a_backend(runs, tmp_path):
    wf = runs[0]
    paths = pub.Publisher(("markdown", "html", "json")).publish(
        wf, str(tmp_path / "out"))
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "report_mnist.md", "report_mnist.html", "report_mnist.json"]
    facts = json.loads(open(paths[2]).read())
    for row, metrics in zip(facts["epochs"], wf.decision.epoch_metrics):
        for set_name, values in metrics.items():
            for key in ("n_err", "count", "loss", "err_pct"):
                assert row["%s_%s" % (set_name, key)] == values[key]
    assert len(facts["epochs"]) == len(wf.decision.epoch_metrics)
    assert open(paths[0]).read().startswith("# Training report: mnist")


def test_pdf_publisher_writes_bytes(runs, tmp_path):
    path, = pub.Publisher(("pdf",)).publish(runs[0], str(tmp_path))
    data = open(path, "rb").read()
    assert path.endswith("report_mnist.pdf") and _pages(data) == 2


def test_publish_confluence_sends_the_reference_request():
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            seen.append((self.path, self.headers["Authorization"],
                         self.headers["Content-Type"], json.loads(body)))
            reply = json.dumps({"id": str(len(seen))}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(reply)))
            self.end_headers()
            self.wfile.write(reply)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d/wiki/" % server.server_address[1]
        for mod in (pub, ref_pub):
            assert mod.publish_confluence(url, "ML", "run 1", _facts(),
                                          auth=("me", "token")) == {
                "id": str(len(seen))}
    finally:
        server.shutdown()
        server.server_close()
    assert len(seen) == 2 and seen[0] == seen[1]
    path, auth, ctype, payload = seen[0]
    assert path == "/wiki/rest/api/content" and ctype == "application/json"
    assert auth == "Basic " + base64.b64encode(b"me:token").decode()
    assert payload["space"] == {"key": "ML"} and payload["type"] == "page"
