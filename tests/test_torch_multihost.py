"""The port's multi-process runs: two gloo processes on 127.0.0.1
(``tests/torch_multihost_worker.py``, one launch for every scenario),
modelled on ``tests/test_multihost.py``.

- ``python -m veles_tpu_torch ... --distributed`` (the graph loop): both
  processes report identical per-epoch metrics and weights, each holds
  half of every minibatch, and the metrics are within 1e-4·(1 + |v|) of
  a single-process run of the same command line (the weight sum within
  1e-3·(1 + |v|), the reference's bars);
- ``--epoch-scan 2`` with ``--distributed``: the same bars against the
  two-process graph loop;
- divergent initial weights are caught by the trainer's digest guard;
- a snapshot written by rank 0 mid-run and restored into fresh builds
  on both processes resumes bit-exactly (the same digests as the
  uninterrupted run);
- ``spmd_loader_shard`` collapses to (0, 1) when one process holds the
  whole mesh, finds the data axis by name, and refuses a layout that is
  not a contiguous equal partition.
"""

import json
import os
import subprocess
import sys

import numpy
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_multihost_worker as worker  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{scenario: [rank 0's result, rank 1's]} (or the error text)."""
    snap_dir = str(tmp_path_factory.mktemp("multihost"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         "2", str(r), snap_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {}
    for out in outs:
        for line in out.splitlines():
            kind, _, rest = line.partition(" ")
            if kind in ("RESULT", "ERROR"):
                name, _, payload = rest.partition(" ")
                got.setdefault(name, []).append(
                    (kind, json.loads(payload)))
    got["snap_dir"] = snap_dir
    return got


def _ok(results, name):
    rows = results.get(name, [])
    assert len(rows) == 2, rows
    for kind, payload in rows:
        assert kind == "RESULT", payload
    return [payload for _, payload in rows]


def _single_process(extra=()):
    from veles_tpu_torch import __main__ as cli, prng
    from veles_tpu_torch.config import root
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prng.reset()
        root.__dict__.pop("mnist", None)
        assert cli.main(worker.cli_argv(extra)) == 0
        wf = cli.main.workflow
        return {"epochs": worker.epoch_rows(wf),
                "wsum": float(numpy.abs(wf.forwards[0].weights.mem).sum())}
    finally:
        root.__dict__.pop("mnist", None)
        prng.reset()
        torch.set_num_threads(threads)


def _within(got, want):
    assert len(got["epochs"]) == len(want["epochs"]) == 2
    for g_epoch, w_epoch in zip(got["epochs"], want["epochs"]):
        for set_name, metrics in w_epoch.items():
            for key, val in metrics.items():
                g = g_epoch[set_name][key]
                assert abs(g - val) <= 1e-4 * (1 + abs(val)), (
                    set_name, key, g, val)
    assert abs(got["wsum"] - want["wsum"]) <= 1e-3 * (1 + want["wsum"])


def test_cli_distributed_trains_and_matches_single_process(results):
    a, b = _ok(results, "cli")
    assert a == b
    assert a["backend"] == "gloo" and a["local_rows"] == 16
    _within(a, _single_process())


def test_cli_distributed_epoch_scan_matches_graph_loop(results):
    scan = _ok(results, "cli_scan")
    assert scan[0] == scan[1]
    _within(scan[0], _ok(results, "cli")[0])


def test_two_process_divergent_init_detected(results):
    for row in _ok(results, "diverge"):
        assert row["caught"] and "initial runner state differs" in \
            row["caught"]


def test_two_process_snapshot_resume_bit_exact(results):
    full = _ok(results, "full")
    assert full[0]["digest"] == full[1]["digest"]
    assert full[0]["local_rows"] == 16
    assert all(row["written"] for row in _ok(results, "first"))
    assert os.path.exists(os.path.join(results["snap_dir"],
                                       "mid.pickle.gz"))
    resumed = _ok(results, "second")
    assert resumed[0]["digest"] == resumed[1]["digest"]
    assert resumed[0]["digest"] == full[0]["digest"]


def test_spmd_loader_shard_single_process_collapses():
    from veles_tpu_torch.parallel import Mesh, spmd_loader_shard
    one = numpy.zeros((4, 2), numpy.int64)      # every device: process 0
    assert spmd_loader_shard(Mesh(one, ("data", "model"))) == (0, 1)
    assert spmd_loader_shard(Mesh(one.T, ("model", "data"))) == (0, 1)
    with pytest.raises(ValueError, match="no 'data' axis"):
        spmd_loader_shard(Mesh(numpy.zeros(2, numpy.int64), ("model",)))
    # one rank a process: each data row is a shard; rows that interleave
    # processes are refused
    grid = numpy.arange(8).reshape(4, 2)
    assert spmd_loader_shard(Mesh(grid, process_index=5)) == (2, 4)
    blocked = numpy.array([[0, 0], [1, 1], [0, 0], [1, 1]])
    with pytest.raises(ValueError, match="contiguous equal partition"):
        spmd_loader_shard(Mesh(blocked, process_index=1))


def test_distributed_refusals_in_one_process():
    """A one-process gloo run on the CPU: ``--no-fused`` and
    ``--stream-window`` refuse ``--distributed`` with the reference's
    errors, and the flags need their coordinator, size and rank."""
    import socket
    from veles_tpu_torch import __main__ as cli, parallel, prng
    from veles_tpu_torch.config import root
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist = ["--distributed", "--coordinator-address", "127.0.0.1:%d" % port,
            "--num-processes", "1", "--process-id", "0"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for extra, said in ((["--no-fused"], "needs a fused workflow"),
                            (["--stream-window", "2"],
                             "does not combine with --distributed")):
            prng.reset()
            root.__dict__.pop("mnist", None)
            with pytest.raises(ValueError, match=said):
                cli.main(worker.cli_argv(dist + extra))
            # the run was joined (once, then reused) under gloo
            assert torch.distributed.get_backend() == "gloo"
        with pytest.raises(ValueError, match="coordinator-address"):
            cli.main(worker.cli_argv(["--distributed"]))
    finally:
        parallel.shutdown()
        root.__dict__.pop("mnist", None)
        prng.reset()
        torch.set_num_threads(threads)
